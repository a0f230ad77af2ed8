#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``filodb_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; every check asserts and any failure exits non-zero:

  1. build   — print the card (``nvidia-smi`` name and power limit), build
               every kernel from ``filodb_tpu_torch/ops/csrc`` (one nvcc per
               source, in parallel) and print the build seconds and each
               entry function's registers and spills (K1's by decode
               variant).
  2. kernels — K1 (the fused-grid kernel) against its plain PyTorch twin on
               the card across the fn x op grid, S in {512, 4096, 65536},
               C in {128, 768}, G in {8, 64}, a sub-range query (c0 > 0) and
               non-finite cells: integer-valued partials bit for bit,
               the rest within rtol 1e-5 of the array's largest magnitude.
               Then K1's decode variants (quant16, delta16, delta8) on blocks
               the port's encoder made on the card, the same grid plus a
               quant16 sub-range query and excluded cohort-pool rows (n = 0,
               garbage blocks, NaN/Inf row operands); K1 on each narrow block
               bit for bit against K1 raw on the decoded block; delta8 with
               c0 > 0 and delta16 at C = 1040 (65 runs a row) refused
               before any launch. Then the launch shapes
               the (row, step) walk and the raw double buffer can get
               wrong (phase_k1_shapes): Tp = 256 and 512, leading steps
               with hi < 0 and 46 live steps, S = 67072 (every block ends
               in a short tile) at C = 768 and 128, C = 1024 and the C of
               the largest shared memory at G = 64 with sumsq, a
               misaligned view (4-byte copies, raw), C = 1004 (i8 and i16
               rows not a multiple of 16 bytes: the narrow ring's 4- and
               8-byte copies), a view of it from row 1 (its base not
               16-byte aligned), C = 1001 (odd-length rows: plain loads)
               and a view of it from row 1, C = 136 (a second decode
               pass) and C = 1024 at columns 512+512 (quant16's ring at
               c0 > 0); raw and the three decode variants, narrow bit for
               bit against raw on the decode.
  2b. quant16 scale — the quant16 encoder on the card and on the CPU over
               rows whose spans lie near, not at, 65535 * 2^k: each
               device's ok rows decode bit for bit; prints how many rows
               the two devices encode differently.
  2c. stream — K3 (the streaming pass) against its plain twin on the card:
               S in {512, 4096, 4196 (100 tail rows it must skip), 65536,
               2^20} x C in {128, 768}, integer data bit for bit and
               bench.py's exponential-cumsum data within rtol 1e-5 of the
               largest magnitude; a misaligned view takes the scalar loads
               and agrees bit for bit; a CPU tensor, f16 and C = 64 are
               refused before any launch. At 2^20 x 768 prints K3's time
               (CUDA events), the plain time, torch.sum(val, 0)'s and the
               bound, and fails if K3 beats its bound (bytes skipped).
  2d. entry  — filodb_tpu_torch.entry.entry() on the card against the same
               step on the CPU (rtol 1e-5); K1 launches once.
  3. small   — about 4096 series x 100 samples through RecordBuilder ->
               shard.ingest -> flush into a CUDA store; the slice's queries
               through QueryEngine.query_range on the card, compared with the
               same engine on the CPU (the plain twins) at rtol 1e-5; K1's
               launch count must advance. Then the same through
               compressed_residency="gauge" stores of each kind's data (one
               series in 8 continuous: the cohort pool): the flush lands on
               the kind, the card matches the CPU, K1 of that kind launches
               once per fused query, and K1 on the store's narrow block
               equals K1 raw on its value_block() bit for bit.
  4. scale   — bench.py's shape, built by filodb_tpu_torch.bench's
               build_engine: 2^20 series registered through the real ingest
               path, 720 samples each (C = 768, 10 s grid) synthesized on
               the card from a seeded torch.Generator; sum(rate(m[5m])) over
               bench.py's 8 range variants through the engine, each against
               the plain twin on the same tensors. Prints the engine's
               single-query p50, K1's time (CUDA events), the plain time,
               K1's bound and launches per query, and K1's time and bound
               on the 30-minute panel's operands (13 steps). Then the
               port's bench on
               the same engine, in this process (bench.measure, what
               ``python3 -m filodb_tpu_torch.bench`` composes after its own
               build_engine): 500 queries x 5 rounds from 64 threads, every
               answer bit-equal to its variant's, K1 launched once per query
               and pipelined dispatch, every reported number finite and
               positive, K3's pass over the store no faster than its bound.
               Prints the bench's result line and the card's busy share in
               each concurrent round (K1 ms x queries / round wall time).
  4b. narrow scale — the same shape through a "gauge" store, once per
               kind: delta8 counters (integer anchors below 2^20, increments
               in [0, 8]), quant16 gauges (half-integer steps), delta16
               (increments in [0, 2000)); one row in 16 with non-integer
               increments (the cohort pool). The queries first run on the
               raw store (residency off), then shard.flush() compresses it
               and they run again: each launches K1 of the kind once and
               agrees with the raw answer (rtol 1e-5); K1 agrees with its
               plain twin at the first and the last range; K1 on the narrow
               block equals K1 raw on value_block() bit for
               bit, and quant16 also on the 30-minute panel's operands
               (c0 > 0). Prints the engine p50, K1's time beside K1 raw's
               on the decoded block (quant16's on the panel too), the
               plain time (one call), the bound, launches per query,
               resident sample bytes raw -> narrow and the compression
               seconds.
  5. hist kernels — K2 (the fused histogram-quantile kernel) against its
               plain twin on the card: fn in {rate, increase, delta} x i8/i16
               dd x S in {512, 4096, 65536} x B in {8, 11, 32} x G in
               {8, 64}, full and sub-range steps, excluded pool rows with
               garbage dd and non-finite first_d (counts bit for bit, sums
               within rtol 1e-5); then one row per group, where every output
               must match bit for bit; then a shape outside the gate must be
               refused. Then the shapes K2's launch design makes risky
               (phase_k2_shapes): row strides that are not a multiple of
               16 (C = 127, B = 11 i8; C = 129, B = 7 i16; C = 129, B = 12
               i8), C = 1024 with every cell needed, G = 64 at Tp * B =
               4096 (the accumulator in scratch), S = 504, a chunk whose
               rows are all excluded, a query with no active step; and
               one row per group, bit for bit, at the unaligned strides.
  6. hist small — 1024 histograms (B = 16) x 100 samples through real
               ingest and flush into CUDA and CPU stores, residency "off"
               and "all" (an eighth of the series non-integer or reset: the
               cohort pool); five histogram_quantile queries on the card
               against the CPU engine (quantiles within 1e-3), with the same
               route, and K2 launched once per K2-route query.
  7. hist scale — the repo's histogram workload: 2^17 series registered
               through the real ingest path, 300 samples x 32 buckets each
               installed on the card from a seeded torch.Generator (one row
               in 16 non-integer), compressed by the shard's flush to i8 dd
               + cohort pool; histogram_quantile(0.9, sum(rate(h[5m]))) over
               39 steps through the engine. Prints the engine p50, K2's time
               (CUDA events) and its fold's, the plain time, K2's bound,
               its launch shape (blocks, rows a pass, stages, shared
               memory, dd bytes in flight per SM), launches per query,
               max |K2 - plain| and resident bytes.
  8a. general small (run after phase 3) — 1024 counters, 256 integer
               gauges and classic le buckets x 100 samples through real
               ingest and flush into CUDA and CPU stores; the general mix
               (every range function, the instant selector, scalar and
               vector operators, and/or/unless, instant, sort, label and
               scalar functions, histogram_quantile over le series, the
               order statistics; query_range and query_instant) on the card
               against the CPU engine: keys, NaN/Inf placement, values
               (counts bit for bit, the rest rtol 1e-5), QueryStats and
               route; K1's launches equal the fused routes QueryStats
               counts, two for the ratio of sums.
  8b. general scale (run after phase 4, on its engine and store) — S1-S7
               over bench range variant 0 (47 steps): S1 a ratio of two
               fused sum(rate) legs (K1 twice) against the quotient of the
               legs; S2 topk(10, rate) against a stable top 10 of the grid
               rate matrix; S3 quantile(0.99, rate) against torch.quantile
               within the sketch's 1.96 %; S4 max(max_over_time) exactly and
               S6 avg(irate) within 1e-9 against a plain windowed max and
               irate written out over the grid-aligned store's cells (no
               code of the engine); S5 count(rate > 0.5) exactly; S7 an instant
               sum(m) at the last sample against the f64 sum of the rows'
               last values (rtol 1e-4: the engine sums f32 as the reference
               does). Prints each query's p50 over 3 runs and its K1
               launches.
  9a. hist general small (run after phase 6) — phase 6's 1024 histograms
               with their sum and count columns in five datasets: residency
               "off" and "all" on one aligned shard, a churned "all" shard,
               an off-grid "off" shard and an "all" dataset over two
               shards; the general histogram mix (range functions and the
               selector over [S, C, B], per-series histogram_quantile /
               histogram_max_quantile, histogram_bucket, the bucket-wise
               sum/count, quantiles of sums, the sum/count ratio of
               __col__ legs; query_range and query_instant) on the card
               against the CPU engine: keys, bucket tops, NaN placement,
               values (integer-valued bit for bit, the rest rtol 1e-5, the
               fused-hist routes' quantiles phase 6's 1e-3), route and
               QueryStats; K2 launches exactly for the K2-route answers, K1
               for the fused legs.
  9b. hist general scale (run after phase 7, on its engine and store) —
               H1 sum(rate(h[5m])) against K2's partials plus the pool
               correction at the same query (rtol 1e-5 of the largest
               sum); H2 histogram_quantile(0.9, rate(h[5m])) over every
               series against a per-bucket Prometheus rate and quantile
               written out in f64 over 64 sampled rows' cells as installed
               (NaN placement equal, rtol 1e-4: the engine's histogram
               grid path computes its rates in f32); H3 the ratio of the
               sum and count columns' sum(rate) (K1 raw twice) against the
               quotient of its legs, each leg against K1's plain twin.
               Prints each query's p50 over 3 runs and its K1 launches.
  10. subqueries and @ at scale (run after 8b, on phase 4's engine and
               store, bench range variant 0) — Q1
               max_over_time(sum(rate(m[5m]))[30m:1m]) (K1 once) exactly
               against a windowed max over its inner query's 1m-grid
               answer; Q2 sum(rate(m[5m] @ <end>)) bit for bit at every
               step against the instant query at <end>, and within 1e-5
               of K1's sum there; Q3
               avg_over_time(rate(m{host=~"h1.*"}[5m])[10m:1m]) over
               159,687 series against a windowed mean of its inner matrix
               in torch (rtol 1e-9). Prints each query's p50 over 3 runs.
  10b. mirror (run after 10, on phase 4's shard) — narrow_mirror on, one
               sample appended and flushed (the flush rebuilds the quant16
               mirror outside the lock): on the continuous values no row is
               exact and the query streams the raw block; the values
               rounded to integers in place and flushed again, every row is
               exact and sum(rate(m[5m])) streams K1-quant16 once, within
               1e-5 of the raw route. Prints the refresh seconds.
  11a. mesh small — 8-shard datasets through real ingest and flush on the
               card and on the CPU (3 to 24 counters a shard; a "gauge"
               dataset of each decode kind; one with cohort-pool rows; a
               raw shard with the mirror): every mesh route (mesh-fused,
               -fused-narrow, -twostep, -topk, -sketch, -empty, the pool
               rows' mesh-fused, the mirror's single-shard K1-quant16)
               through QueryEngine(mesh=["cuda"]) against
               QueryEngine(mesh=["cpu"] * 8): route, QueryStats, keys, NaN
               placement, values (counts bit for bit, the rest rtol 1e-5);
               K1 launched 8 times a fused mesh query, by decode kind.
  11b. mesh scale — bench.py's 2^20 x 720 store split over 8 shards of
               2^17 (real registration, delta8-exact counters from a
               seed), one memstore, QueryEngine(mesh=["cuda"]) against the
               host loop: M1 sum(rate), M2 avg by (grp) (rate), M3
               max(rate), M4 topk(5, rate), M5 quantile(0.99, rate), M6 M1
               after the shards go delta8-resident. Routes, 8 K1 launches a
               fused query, the mesh answer bit for bit the host loop's
               (M4: keys equal, values bit for bit); M5's sketch holds every
               series once a step. Prints each query's p50 over 3 after a
               warm run (M2, ~5.8 s of Python keys a query: one run, no
               warm), both engines, and the 8 per-shard K1 times beside
               phase 4's one launch over 2^20 rows.

  12a. serving small (run after 8a) — the engine's serving fast path
               (every cache and admission on) over 6-9 integer counters in
               an 8-slot shard, on the card and on the CPU: cold, a
               result-cache hit, a shifted range (the fragment cache runs
               only the new steps), a tail ingest and a further shift, a
               release by eviction (the caches invalidate), a typo'd
               metric twice (a negative hit). Route, QueryStats, cache
               stats and epoch vectors equal, values within rtol 1e-5;
               label values and names, series and raw_series equal; K1
               launched once a step that executes, never on a hit.
  12b. serving scale (run after 10b, on phase 4's store: its ingest adds a
               sample) — three engines with every cache and admission on,
               phase 4's engine (caches off) their oracle; sum(rate(m[5m]))
               over bench variant 0: a cold miss, a result-cache hit, a
               shift by 4 steps (the tail alone through K1), one new sample
               for all 2^20 series through RecordBuilder and a flush, a
               further shift over it, a typo'd metric twice, then one
               concurrent round of 500 queries over bench's 8 variants.
               Prints each step's p50 over the 3 engines, its K1 launches
               (0 on a hit, 1 on an incremental query) and K1's (Tp,
               active columns, G) for the full range and the tail,
               fragment_steps_reused, estimate_cost's ms and the result
               caches' device bytes; every answer within rtol 1e-5 of the
               oracle's, and whether it was bit-equal.

  13a. durable small (run after 12a) — 32 counters and 16 gauges (4
               stop early) and 16 histograms (B = 8) x 180 samples, each
               container published to a FileBus and ingested with its
               offset into sink-backed shards (groups_per_shard = 4, a
               FileColumnStore in a temporary directory, the inline 1m
               downsampler attached); the first 2/3 persisted, then a
               crash. On the card and again on the CPU: recover from the
               sink and the bus (the downsampler re-seeded from the
               loaded chunks); the histogram dataset recovered into an
               "all" shard and its quantile through K2; the gauge dataset
               recovered into a "gauge" shard and sum(rate) through
               K1-delta8 (bit for bit K1 raw on the decode); the store
               compacted and cold ranges paged in through the narrow and
               the wide path (ODP_BATCH lowered to 16) and raw_series;
               purge and the durable age-out with their epoch bumps; the
               batch (5m) and cascade (1m -> 10m) jobs; the families
               loaded, ``__col__``, a routed stitched query and
               resolution="5m". Card against CPU: index, rows, epochs,
               routes, QueryStats (rows_paged_in, resolution), counts and
               every sink file equal, answers within rtol 1e-5 (quantiles
               1e-3); the recovered answers bit for bit the pre-crash ones;
               K1 / K2 launched exactly for the fused routes.
  13b. durable scale (run last) — a restart of one 2^17 x 720 shard of
               exact counters, f32 on the card, groups_per_shard = 16:
               6 RecordBuilder containers published to a FileBus and
               ingested with offsets, the first 4 persisted
               (flush_all_groups, the inline 5m downsampler on), a crash;
               sum(rate(m[5m])) and two selections (4096 and 8192 series)
               through K1 before it; a fresh memstore on the card
               recovers from the sink and the bus; the same queries
               through K1 bit for bit (else within rtol 1e-5, and said);
               the oldest 2/3 compacted away and the two selections paged
               back in (one ODP batch, two) within rtol 1e-5 of the
               pre-crash answers; the replayed third persisted, the 5m
               family (24 buckets a series) loaded and
               sum(avg_over_time(m[30m])) at 5m through the router with
               resolution="5m" (K1, the closed band) against a numpy
               oracle over the published records (rtol 1e-5). Prints the
               flush seconds and on-disk bytes a sample, the recovery's
               index ms, chunk load and replay seconds, the cold and
               resident query ms and paged series/s, the routed query ms
               against raw, on the host clock, with the card.
  14a. cluster small (run after 11b) — the reference's two-node fixture
               (tests/test_remote_exec.py: 8 series of two metrics, a
               2-shard dataset) as two in-process nodes, each a memstore
               with one shard, a QueryEngine with the ShardManager and a
               FiloHttpServer, on the card and again on the CPU: the 19
               queries on either node bit for bit the one-node oracle on
               the same device, the card within rtol 1e-5 of the CPU,
               QueryStats equal; the metadata API federated; a 4-shard
               split batched (one /exec POST a peer a query), the
               co-located reduce (a node owning nothing ships the reduce
               whole: one POST), replan-once after a peer's server stops;
               one shard flushed through a ReplicatedColumnStore (RF 2)
               over three StoreServers, the first holder stopped, the
               shard recovered bit for bit. Prints K1 launches by step and
               node.
  14b. cluster scale (run after 14a, on 11b's shards as they are:
               delta8-resident) — the 8 shards of 2^17 x 720 split 4/4
               over nodes a and b, queried over HTTP through node a,
               against one node's host loop over the same shards: M1
               sum(rate), a grouped sum by (grp), topk(5, rate) and
               quantile(0.9, rate), each answer bit for bit the host
               loop's. Prints host ms p50, bytes on the wire a query, K1
               launches by node (4 each for M1), the stage ms and M1 again
               with the interpreter's switch interval at 0.5 ms.
  14c. cluster processes — two fresh interpreters, each a node
               (python -m filodb_tpu_torch.entry --cluster-node: a file
               registrar, ClusterBootstrap.resolve_world, a Gloo process
               group, MembershipMonitor publishing its HTTP endpoint, one
               seeded 2^17 x 720 shard on the card); this process builds
               both shards on one node as the oracle. M1 and topk through
               either node bit for bit the oracle, each rank's all_reduce
               of its partials equal to M1. Prints host ms (a first call,
               then p50 over 3) and K1 launches by rank.
  15a. server small (run after 14) — two BrokerServer nodes (4
               partitions, replication 2, min_insync 2, epoch fencing), a
               FiloServer on the card with 4 shards (spread 2), a data_dir
               sink, the gateway and a file registrar, and a CPU FiloServer
               on the same brokers; 256 SyntheticStream counters x 64
               samples through BrokerBus and 320 Influx lines through the
               gateway. sum(rate), sum by (dc) (rate) and avg_over_time
               over HTTP bit for bit a memstore on the card fed the
               broker's containers directly, within rtol 1e-5 of the CPU
               server; route "local" with QueryStats.fused_kernels 4 and
               K1 once a shard leaf; K1 against its plain twin on the
               server's own shard stores. Then the leader broker killed by
               a FaultPlan mid-stream and started again (min_insync 2: the
               survivor sheds until it rejoins), the pub-id audit (dense
               offsets, unique ids, every acked id logged, both logs
               identical), a restart of the server from its sink and the
               broker's replay, and a live move of shard 3 to a second
               FiloServer through POST /api/v1/cluster/rebalance: the
               answers bit for bit the same after each. Last, 8
               counters born mid-stream through the gateway (series
               churn): their shards page the selection in from the sink,
               off K1's route; held within rtol 1e-5 of the memstore,
               printing rows paged in and K1's launches a query.
  15b. server scale — 4 x 2^15 SyntheticStream counters x 64 samples
               (8.4 M rows) through the same broker pair into a FiloServer
               on the card. Prints publish and ingest rows/s, the seconds
               from the last publish until every sample answers, the host
               ms p50 over HTTP of sum(rate(m[5m])) over the 2^17 series
               (K1 4 a query), the card's memory; the answer bit for bit a
               memstore fed the same containers directly. Also the host
               seconds of the ingest stages, the card's busy share over
               the traced ingest window, K1's passes of one query by CUDA
               events, and the traced queries' device ms and busy share.
  15c. server processes — entry.dryrun_multichip's step 5 on the card: two
               FiloServer processes (python -m filodb_tpu_torch.cli serve
               --device cuda), one shard each, over one broker and a file
               registrar, both answering bit for bit as one memstore of
               both shards; prints the seconds until both answer.
  16a. rules small (run after 15) — Prometheus remote write and read and
               the rules subsystem on a FiloServer on the card (4 shards,
               a sink, rules.groups at 1 s: sum(rate), sum by (job)
               (rate), 2 x the first rule's output; alerts with for: 3s
               and zero-for) and a CPU FiloServer over 15's broker pair,
               and a webhook receiver. 64 counters x 600 samples and a
               load counter by remote write (204; a spoofed __rule__ 422;
               a malformed body 400), and an f64 card/CPU pair for the
               429 edge and the stale marker's bits. A partition leader
               killed while the rules publish and brought back; the
               alert pending, the server restarted from its sink, then
               firing with its first active_at, then resolved. Derived
               samples bit for bit the card's own instant queries, the CPU
               server within rtol 1e-5; every (rule, eval_ts) once in the
               broker log; K1 once a shard leaf a fused rule evaluation;
               rules.streaming's catch-up the instant path's rows; remote
               read bit for bit and byte for byte the CPU's body; K1
               against its twin on the server's stores.
  16b. rules scale — (i, after 16a) 2^15 counters (six labels) as
               2000-sample WriteRequests from 4 client threads into a
               4-shard FiloServer on the card, in two cells: a backfill
               (32 samples a series, a series' samples together) that
               creates the series, then Prometheus's live shape (2 more
               scrape rounds, one sample a series a request): accepted
               samples/s, host CPU seconds by stage, seconds until every
               sample answers. (ii, before phase 4, on its engine as
               bench.py builds it) four recording rules and an alert over
               2^20 series, 16 ticks at 60 s through run_group_once with
               rules.streaming off and on: the rows bit for bit the same
               in both, into two sibling datasets; ms and device ms a
               tick, K1 launches. (iii) a remote read of 1024 series x 720
               samples of phase 4's store over HTTP, bit for bit the
               store's: ms, bytes, samples/s.
  17.  lock round (after 16b(ii)/(iii), before phase 4, on its engine as
               bench.py builds it: 2^20 raw f32 series x 720 samples,
               exponential(1) x 5 increments cumulated, torch.Generator
               seed 7; 16b only reads it) — diagnostics and the lock debug
               mode on (restored after), 8 threads each run 16
               sum(rate(m[5m])) range queries over bench.py's 8 ranges
               through K1 raw. Every answer bit for bit the serial one of
               its range (the 8 serial queries counted apart), no
               DiagnosticsError, K1 raw launches exactly 128, and the
               node's /metrics (FiloHttpServer: _sync_shard_stats, then
               expose_prometheus) carrying the shard's two lock gauges at
               the lock's own counts. Prints the shard lock's contentions
               and long holds and filodb_lock_hold_ms{class="shard"}'s
               count, p50 and p99 beside the card's name and power limit.
  18.  soak (after 14b, on 11b's 8 delta8 shards) — 18a: three nodes a,
               b, c in this process adopt all 8 shards (no copy), the
               ShardManager deals them 3/3/2, each node has its HTTP
               server; S1-S4 (the reference three-node test's shapes over
               the metric and its grp label; the grouped S2 over 8 % of
               the hosts), M1 and two joins (over the same 8 %) through
               every node over HTTP, each bit for bit one node's host
               loop, 2 /exec POSTs a query, K1 by node 3/3/2 for the fused
               sum(rate); one trace with serve spans from b and c; c
               killed: one replan, its shards split over a and b, every
               answer through a and b as before, K1 4/4; the
               reference join test's whole list at its own size on three
               card nodes, bit for bit one card node and within rtol 1e-5
               of the CPU cluster. 18b: a FiloServer on the card (data_dir,
               1m downsampling) fed 4096 gauges x 1 h at 7 s through a
               FileBus, the port's downsample validator over the hour;
               then two servers on one broker, the validator over the
               hour against each node's port; every
               column compared for every series at every closed bucket,
               0 mismatches, max rel err <= 1e-6. 18c: the six soaks of
               filodb_tpu_torch.stress at the reference's defaults
               (streaming 10 s, cluster 15 s),
               each passing its own checks; query, streaming and cluster
               launch K1 raw in their timed runs (the kernels line
               counts those, the soaks' check queries apart). Prints
               each step's ms, rows/s, queries/s,
               p50/p99, the takeover gap and K1's launches beside the
               card's name and power limit.
  19.  bench suite (run last) — every suite of the port's benchmark
               suite (``filodb_tpu_torch/scripts/bench_suite.py``, the
               twin of ``scripts/bench_suite.py``) on the card, in
               process, at its default size; query_hicard and hist_query
               again at ``--full`` (the jmh shapes). Each suite prints
               exactly its declared metric names and passes its own
               assertions (the result cache's route and bit parity, the
               fused tier against the composed ``off`` chain within 2e-5
               a cell, the mesh's route and bit parity, the admission
               invariants, the ingest and elastic zero-loss /
               zero-duplicate audits, the residency ladders' bit parity).
               K1 raw launches in query_hicard, serving, fused_resident
               and mesh_query, K1-delta8, -quant16 and -delta16 in
               scalar_residency, K2 in fused_resident and hist_retention;
               fused_resident's "off" legs launch neither, and the fused
               mode is the default again after the phase. Prints each
               suite's wall seconds and launches by kind (the launches a
               suite makes only to hold a kernel against its plain twin
               left out); each suite's lines go to
               chiprun_out/bench_suite_phase19.jsonl.

The two lines before the last are the card and the kernel table
({"kernels": [...]}); the last line is {"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside it, it exits 2 and
prints no result (1 where torch itself is missing).

    python3 chip_smoke.py --profile-hist [--query PROMQL ...]

instead builds phase 7's store and profiles its query, or each query
``--query`` names over phase 7's range (torch.profiler and cProfile,
tables also written to chiprun_out/); it prints no result line.

    python3 chip_smoke.py --k2-parts OUT [--root DIR]
    python3 chip_smoke.py --k2-compare A B [...]

compare two checkouts' K2 on one card: --k2-parts builds phase 7's store
with the package in DIR (default: beside this script), prints the engine's
single-query p50 and K2's time by CUDA events, and saves K2's partials at
phase 7's query to OUT; --k2-compare says whether saved partials are equal
bit for bit. Neither prints a result line.

    python3 chip_smoke.py --k1-narrow [--root DIR]

runs phase 2's K1 launch-shape checks, phase 2c's K3 pass and phase 4b's
narrow scale timings alone, with the package in DIR (default: beside this
script), and prints no result line: timed in turns on one card, two
checkouts' K1 decode variants (K1-<kind> beside K1 raw on the decoded
block, in one "k1-narrow" summary line a run).

    python3 chip_smoke.py --durable

runs phases 13a and 13b alone (after the kernels' build) and prints no
result line.

    python3 chip_smoke.py --cluster

runs phase 14 alone (after the kernels' build; 14b on 11b's shards built
and made delta8-resident for it) and prints no result line.

    python3 chip_smoke.py --server

runs phase 15 alone (after the kernels' build) and prints no result line.

    python3 chip_smoke.py --rules

runs phase 16 alone (after the kernels' build; 16b(ii) and (iii) on
phase 4's engine built for it) and prints no result line.

    python3 chip_smoke.py --locks

runs phase 17 alone (after the kernels' build, on phase 4's engine built
for it) and prints no result line.

    python3 chip_smoke.py --soak

runs phase 18 alone (after the kernels' build; 18a on 11b's shards built
and made delta8-resident for it) and prints no result line.

    python3 chip_smoke.py --bench-suite

runs phase 19 alone (after the kernels' build) and prints no result line.
"""

import contextlib
import gc
import itertools
import json
import os
import re
import shutil
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# --root DIR (with --k2-parts or --k1-narrow only): the package of another
# checkout
ROOT = (os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
        if "--root" in sys.argv[1:-1] else HERE)
if not os.path.isdir(os.path.join(ROOT, "filodb_tpu_torch")):
    print(f"chip_smoke: filodb_tpu_torch/ is not in {ROOT}",
          file=sys.stderr)
    sys.exit(2)
sys.path.insert(0, ROOT)

# bench.py's north-star shape, as the port's bench holds it
from filodb_tpu_torch.bench import (  # noqa: E402
    BASE_TS, CAPACITY, DATA_BATCH, INTERVAL_MS, NUM_SAMPLES, NUM_SERIES,
    STEP_MS, SUB_RANGE_MS, WINDOW_MS, cuda_ms, range_variants)

# the histogram workload: scripts/bench_suite.py hist_retention/hist_query
# (after the reference's HistogramQueryBenchmark) at B = 32 — at Tp = 128,
# B = 64 exceeds K2's Tp * B <= 4096 gate — and 2^17 series in one shard
HIST_SERIES = 1 << 17
HIST_SAMPLES = 300
HIST_CAPACITY = 320
HIST_BUCKETS = 32
HIST_STEP_MS = 60_000
HIST_QUERY = "histogram_quantile(0.9, sum(rate(req_latency[5m])))"
HIST_BATCH = 1 << 13
EXCLUDED_GID = 1 << 30
# the rows phase 9b holds H2 against: every residue mod 16 (four of them
# are cohort-pool rows, 15 mod 16)
HIST_SAMPLE_ROWS = tuple(range(3, 64 * 2047, 2047))
HIST_FNS = ("rate", "increase", "delta")

# the flush's ladder, in order (core/chunkstore.py::_prepare_scalar)
NARROW_KINDS = ("delta8", "quant16", "delta16")

SLICE_QUERIES = ("sum(rate(m[5m]))", "avg by (host) (rate(m[5m]))",
                 "stddev(rate(m[5m]))", "sum(increase(m[5m]))",
                 "count(avg_over_time(m[5m]))", "rate(m[5m])")
FNS = ("rate", "increase", "delta", "sum_over_time", "avg_over_time",
       "count_over_time")
OPS = ("sum", "avg", "count", "group", "stddev", "stdvar")

# published peaks per card (NVIDIA data sheets): memory bytes/s, f32 FLOP/s
# outside the tensor cores
PEAKS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def log(*a):
    print(*a, flush=True)


def log_build(kernels, fg, names) -> None:
    """The build log's line a kernel: its registers and spills from nvcc's
    ``-Xptxas -v`` report (K1's entry points named with their decode
    variant, and the dynamic shared memory a block of that variant asks
    for at bench.py's shape beside raw's: ptxas does not see it), or the
    report's register and spill lines as they are where it names no entry
    function or the package (``--root``, an older checkout) has no
    parser."""
    kinds = {0: "raw", 1: "quant16", 2: "delta16", 3: "delta8"}
    parse = getattr(kernels, "ptxas_usage", lambda report: [])
    rt = fg.k1_launch_shape(NUM_SERIES, CAPACITY, fg.K1_STEPS, 8, 2)[0]
    for name in names:
        report = kernels.build_log.get(name, "")
        usage = parse(report)
        for u in usage:
            m = re.fullmatch(r"fused_grid_map\w*<(\d)>", u["kernel"])
            kind = smem = ""
            if m:
                kind = kinds[int(m.group(1))]
                smem = (f"; {fg.k1_smem_bytes(CAPACITY, rt, 8, 2, kind)} "
                        f"bytes of shared memory a block at {NUM_SERIES} x "
                        f"{CAPACITY}, G = 8 (raw's "
                        f"{fg.k1_smem_bytes(CAPACITY, rt, 8, 2, 'raw')})")
                kind = f" ({kind})"
            log(f"build: {name}: {u['kernel']}{kind}: {u['registers']} "
                f"registers, {u['spill_stores']} bytes spill stores, "
                f"{u['spill_loads']} bytes spill loads{smem}")
        if not usage:
            for line in report.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"build: {name}: {line.strip()}")


def peaks_for(name: str):
    for key, bw, f32 in PEAKS:
        if key in name:
            return key, bw, f32
    return "H100", 3.35e12, 67e12


def compare_parts(got: dict, ref: dict, exact_keys, what: str) -> float:
    """Assert K1's partials against the plain twin's; returns max |diff|."""
    import numpy as np
    assert set(got) == set(ref), (what, set(got), set(ref))
    worst = 0.0
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, (what, k, g.shape, r.shape)
        assert (np.isnan(g) == np.isnan(r)).all(), (what, k, "NaN pattern")
        fin = np.isfinite(r)
        if k in exact_keys:
            assert np.array_equal(g, r, equal_nan=True), (what, k, "not exact")
        else:
            scale = float(np.abs(r[fin]).max(initial=0.0))
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                                       equal_nan=True, err_msg=f"{what} {k}")
        if fin.any():
            worst = max(worst, float(np.abs(g[fin] - r[fin]).max()))
    return worst


def reset_k1(fg):
    """K1's launch counts to 0, in all and by decode variant."""
    fg.fused_grid_kernel.launches = 0
    for k in fg.fused_grid_kernel.launches_by_kind:
        fg.fused_grid_kernel.launches_by_kind[k] = 0


def same_outputs(a, b) -> bool:
    """Bit-equal tensors (NaN where the other has NaN)."""
    return all(bool(((x == y) | (x.isnan() & y.isnan())).all())
               for x, y in zip(a, b))


def make_block(torch, S, C, integer, seed, dev):
    """[S, C] f32 rows with short counts, made on the card. ``integer``:
    small integer gauges (every partial stays an integer below 2^24, exact
    in any summation order); else counters with resets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    col = torch.arange(C, device=dev)[None, :]
    if integer:
        val = torch.randint(0, 4, (S, C), generator=g, device=dev).float()
    else:
        inc = torch.empty((S, C), device=dev).exponential_(generator=g) * 5.0
        val = torch.cumsum(inc, dim=1)
        reset = torch.randint(0, 8, (S,), generator=g, device=dev) == 0
        cut = torch.randint(1, C, (S,), generator=g, device=dev)
        after = reset[:, None] & (col >= cut[:, None])
        val = torch.where(after, val - torch.gather(val, 1, cut[:, None]), val)
    n = torch.full((S,), C, dtype=torch.int32, device=dev)
    short = torch.randint(0, 4, (S,), generator=g, device=dev) == 0
    n = torch.where(short, torch.randint(0, C, (S,), generator=g, device=dev,
                                         dtype=torch.int32), n)
    val = torch.where(col >= n[:, None].long(), torch.full_like(val, 7.0e6), val)
    return val.contiguous(), n


def phase_kernels(torch, np, fg, dev):
    cases = []
    for S in (512, 4096, 65536):
        for C in (128, 768):
            for G in (8, 64):
                cases.append((S, C, G, False))
    cases.append((4096, 768, 8, True))          # sub-range: c0 > 0
    worst = 0.0
    checks = 0
    for i, (S, C, G, sub) in enumerate(cases):
        integer = i % 2 == 0
        val, n = make_block(torch, S, C, integer, 100 + i, dev)
        gids = torch.randint(0, G, (S,), device=dev, dtype=torch.int32,
                             generator=torch.Generator(device=dev).manual_seed(i))
        if sub:
            out_ts = np.arange((C - 180) * INTERVAL_MS, (C - 1) * INTERVAL_MS + 1,
                               STEP_MS, dtype=np.int64)
        else:
            out_ts = np.arange(WINDOW_MS, (C - 1) * INTERVAL_MS + 1, 60_000,
                               dtype=np.int64)
        T = len(out_ts)
        Tp = -(-T // 128) * 128
        plain = {}
        for fn in FNS:
            kind = "window" if fn in fg.FUSED_WINDOW_FNS else "rate"
            band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
                C, Tp, out_ts.tobytes(), WINDOW_MS, 0, INTERVAL_MS, kind,
                False, val.device)
            if sub:
                assert c0 > 0, (C, c0, Ca)
            for sumsq in (False, True):
                plain[fn, sumsq] = fg.fused_grid_aggregate_plain(
                    fn, sumsq, WINDOW_MS, INTERVAL_MS, val, n, gids, band,
                    ohlo, lo, hi, rel, G, c0, Ca)
            for op in OPS:
                sumsq = op in ("stddev", "stdvar")
                got = fg.fused_grid_aggregate(op, fn, val, n, gids, G, out_ts,
                                              WINDOW_MS, 0, INTERVAL_MS)
                ref = fg.PaddedPartials(plain[fn, sumsq], op, G, T).resolve()
                exact = {"count"} | ({"sum"} if integer and fn in (
                    "sum_over_time", "count_over_time") else set())
                worst = max(worst, compare_parts(
                    got, ref, exact, f"S={S} C={C} G={G} {fn} {op}"))
                checks += 1
    # non-finite cells: NaN/inf spread like the band and one-hot products
    val, n = make_block(torch, 4096, 768, False, 7, dev)
    val[5, 40] = float("nan")
    val[777, 300] = float("inf")
    # finite cells whose increment overflows to +inf (K1 counts such rows
    # cell by cell: a cell outside (-2^126, 2^126))
    val[901, 200], val[901, 201] = -3.0e38, 3.0e38
    n[5] = n[777] = n[901] = 768
    gids = (torch.arange(4096, device=dev) % 8).to(torch.int32)
    out_ts = np.arange(WINDOW_MS, 767 * INTERVAL_MS + 1, 60_000, dtype=np.int64)
    for fn in ("rate", "delta", "sum_over_time"):
        got = fg.fused_grid_aggregate("stddev", fn, val, n, gids, 8, out_ts,
                                      WINDOW_MS, 0, INTERVAL_MS)
        band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
            768, 128, out_ts.tobytes(), WINDOW_MS, 0, INTERVAL_MS,
            "window" if fn in fg.FUSED_WINDOW_FNS else "rate", False, val.device)
        ref = fg.PaddedPartials(fg.fused_grid_aggregate_plain(
            fn, True, WINDOW_MS, INTERVAL_MS, val, n, gids, band, ohlo, lo,
            hi, rel, 8, c0, Ca), "stddev", 8, len(out_ts)).resolve()
        assert any(np.isnan(v).any() for v in ref.values())
        compare_parts(got, ref, {"count"}, f"non-finite {fn}")
        checks += 1
    torch.cuda.synchronize()
    return checks, worst


def narrow_block_dev(torch, narrow, kind, S, C, seed, dev):
    """(ops, n, dec): an [S, C] block of ``kind`` made on the card and
    encoded there by the port's encoder (``ops = (block, *row_operands)``),
    with short rows, rows of 0 and 1 samples, and one row in 8 excluded as
    a cohort-pool row is: n = 0, a garbage block, a NaN or Inf row operand.
    ``dec`` is the decoded f32 block (the variant's registry decode)."""
    from filodb_tpu_torch.ops import decodereg
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)
    if kind == "delta8":                      # counters
        val = torch.cumsum(ints(0, 30, (S, C)), 1) + ints(0, 1 << 20, (S, 1))
    elif kind == "delta16":                   # wide integer increments
        val = torch.cumsum(ints(200, 3000, (S, C)), 1)
    else:                                     # half-integer gauges
        val = (1000.0 + 0.5 * torch.cumsum(ints(0, 3, (S, C)), 1)
               + ints(0, 100, (S, 1)))
    val = val.float().contiguous()
    n = torch.full((S,), C, dtype=torch.int32, device=dev)
    n = torch.where(ints(0, 4, (S,)) == 0, ints(0, C, (S,)).to(torch.int32), n)
    n[5], n[6] = 0, 1
    if kind == "quant16":
        q, vmin, scale, ok = narrow.build_narrow(val, n)
        ops = [q, vmin, scale]
    else:
        dv, anchor, ok16, ok8, _ = narrow.build_narrow_delta(val, n)
        ok = ok8 if kind == "delta8" else ok16
        ops = [narrow.cast_narrow_delta_i8(dv) if kind == "delta8" else dv,
               anchor]
    assert bool(ok.all()), f"the encoder refused {kind} rows"
    pool = torch.arange(3, S, 8, device=dev)
    n[pool] = 0
    lim = 127 if kind == "delta8" else 32767
    ops[0][pool] = ints(-lim, lim, (len(pool), C)).to(ops[0].dtype)
    ops[1][pool] = float("nan")
    ops[-1][pool[1::2]] = float("inf")
    dec = decodereg.variant(kind).decode(ops[0], *(o[:, None] for o in ops[1:]))
    return tuple(t.contiguous() for t in ops), n, dec.contiguous()


def phase_narrow_kernels(torch, np, fg, narrow, dev,
                         sizes=(512, 4096, 65536)):
    """K1's decode variants against the plain twin over fn x op, S, C, G,
    a sub-range query (c0 > 0 for quant16; the delta variants read whole
    rows) and excluded pool rows: counts bit for bit, sums within rtol 1e-5
    of the largest magnitude; K1 on each narrow block bit for bit against
    K1 raw on the decoded block at the same columns; delta8 at c0 > 0
    refused before a launch, and delta16 at C = 1040 (65 runs a row)."""
    from filodb_tpu_torch.ops import decodereg
    cases = [(S, C, G, False) for S in sizes for C in (128, 768)
             for G in (8, 64)]
    cases.append((4096, 768, 8, True))
    worst = dict.fromkeys(NARROW_KINDS, 0.0)
    checks = exact = 0
    for kind in NARROW_KINDS:
        full = decodereg.variant(kind).full_columns
        for i, (S, C, G, sub) in enumerate(cases):
            ops, n, dec = narrow_block_dev(torch, narrow, kind, S, C, 400 + i,
                                           dev)
            gids = torch.randint(0, G, (S,), device=dev, dtype=torch.int32,
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(i))
            if sub:
                out_ts = np.arange((C - 180) * INTERVAL_MS,
                                   (C - 1) * INTERVAL_MS + 1, STEP_MS,
                                   dtype=np.int64)
            else:
                out_ts = np.arange(WINDOW_MS, (C - 1) * INTERVAL_MS + 1,
                                   60_000, dtype=np.int64)
            T = len(out_ts)
            Tp = -(-T // 128) * 128
            for fn in FNS:
                fk = "window" if fn in fg.FUSED_WINDOW_FNS else "rate"
                band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
                    C, Tp, out_ts.tobytes(), WINDOW_MS, 0, INTERVAL_MS, fk,
                    full, dev)
                assert (c0 > 0) == (sub and not full), (kind, c0, Ca)
                plain = {sq: fg.fused_grid_aggregate_plain(
                    fn, sq, WINDOW_MS, INTERVAL_MS, ops[0], n, gids, band,
                    ohlo, lo, hi, rel, G, c0, Ca, kind, ops[1:])
                    for sq in (False, True)}
                for op in OPS:
                    got = fg.fused_grid_aggregate(
                        op, fn, None, n, gids, G, out_ts, WINDOW_MS, 0,
                        INTERVAL_MS, narrow=(kind, ops))
                    ref = fg.PaddedPartials(plain[op in ("stddev", "stdvar")],
                                            op, G, T).resolve()
                    ex = {"count"} | ({"sum"} if fn == "count_over_time"
                                      else set())
                    worst[kind] = max(worst[kind], compare_parts(
                        got, ref, ex, f"{kind} S={S} C={C} G={G} {fn} {op}"))
                    checks += 1
                # the decode is exact: the same launch on the decoded block
                a = fg.fused_grid_kernel(fn, True, WINDOW_MS, INTERVAL_MS,
                                         ops[0], n, gids, lo, hi, rel, G, c0,
                                         Ca, kind, ops[1:])
                b = fg.fused_grid_kernel(fn, True, WINDOW_MS, INTERVAL_MS,
                                         dec, n, gids, lo, hi, rel, G, c0, Ca)
                assert same_outputs(a, b), (kind, S, C, G, sub, fn,
                                            "narrow != raw on the decode")
                exact += 1
    # delta8 decodes whole rows: a column offset is refused before a launch
    ops, n, _ = narrow_block_dev(torch, narrow, "delta8", 512, 256, 7, dev)
    zeros = torch.zeros(512, dtype=torch.int32, device=dev)
    lo = torch.zeros(128, dtype=torch.int32, device=dev)
    before = fg.fused_grid_kernel.launches
    try:
        fg.fused_grid_kernel("rate", False, WINDOW_MS, INTERVAL_MS, ops[0], n,
                             zeros, lo, lo, lo, 8, 128, 128, "delta8", ops[1:])
        raise AssertionError("K1 accepted delta8 at c0 = 128")
    except ValueError:
        pass
    # and at most K1_MAX_RUNS runs of 16 cells a row: C = 1040 is refused
    ops, n, _ = narrow_block_dev(torch, narrow, "delta16", 512, 1040, 8, dev)
    try:
        fg.fused_grid_kernel("rate", False, WINDOW_MS, INTERVAL_MS, ops[0], n,
                             zeros, lo, lo, lo, 8, 0, 1040, "delta16",
                             ops[1:])
        raise AssertionError("K1 accepted delta16 at C = 1040")
    except ValueError:
        pass
    assert fg.fused_grid_kernel.launches == before
    torch.cuda.synchronize()
    return checks, exact, worst


def k1_shape_cases(np, fg):
    """(name, S, C, G, out_ts, view) of the launch shapes K1's (row, step)
    walk and its staging can get wrong beyond phase 2's grid: several step
    chunks (blockIdx.y > 0), leading dead steps (hi < 0) and a live count
    that is not a multiple of 32, blocks whose rows end in a short tile,
    the largest shared memory a fusable shape asks for (at C = 1024 and at
    the C that maximises k1_smem_bytes, G = 64 with sumsq), a misaligned
    view (``view`` "columns": raw's 4-byte copies), and the delta ring's
    edges: C = 1004 (rows of 1004 or 2008 bytes, 4- and 8-byte copies), a
    view of it from row 1 (``view`` "rows": a base that is not 16-byte
    aligned, every kind), C = 1001 (odd-length rows: plain loads) and a
    view of it from row 1, C = 136 (30 rows a tile, 28 a decode pass: a
    second pass); and quant16's ring at c0 > 0 (C = 1024, columns 512+512:
    raw and quant16 read the active columns only)."""
    def full(C, step):
        return np.arange(WINDOW_MS, (C - 1) * INTERVAL_MS + 1, step,
                         dtype=np.int64)

    def smem(C):
        rt = fg.k1_launch_shape(4096, C, 128, 64, 3)[0]
        return fg.k1_smem_bytes(C, rt, 64, 3)
    c_max = max(range(8, fg.MAX_CAPACITY + 1, 8), key=smem)
    # S = 67072: 66 rows a block, so every block ends in a short tile (1
    # row after 13 of 5 at C = 768, 2 rows after 2 of 32 at C = 128)
    short = 67072
    for C in (768, 128):
        rt, rows_per_block, _ = fg.k1_launch_shape(short, C, 128, 8, 2)
        assert rows_per_block % rt != 0, (C, rt, rows_per_block)
    # windows from cell 520 on: active columns 512+512 of 1024
    late = np.arange(WINDOW_MS + 520 * INTERVAL_MS,
                     1023 * INTERVAL_MS + 1, 60_000, dtype=np.int64)
    return [
        ("Tp=256", 4096, 768, 8, WINDOW_MS + np.arange(250) * 29_000, None),
        ("Tp=512", 4096, 768, 64, WINDOW_MS + np.arange(500) * 14_000, None),
        ("4 dead leading steps, 46 live", 4096, 768, 8,
         np.arange(-200_000, 2_250_001, 50_000, dtype=np.int64), None),
        ("short last tile", short, 768, 8, full(768, 60_000), None),
        ("short last tile, C=128", short, 128, 8, full(128, 60_000), None),
        ("C=1024, G=64", 4096, 1024, 64, full(1024, 60_000), None),
        (f"largest smem, C={c_max}, G=64", 4096, c_max, 64,
         full(c_max, 60_000), None),
        ("misaligned view", 4096, 768, 8, full(768, 60_000), "columns"),
        ("C=1004", 4096, 1004, 8, full(1004, 60_000), None),
        ("C=1004 from row 1", 4096, 1004, 8, full(1004, 60_000), "rows"),
        ("C=1001", 4096, 1001, 8, full(1001, 60_000), None),
        ("C=136, two decode passes", 4096, 136, 8, full(136, 30_000), None),
        ("C=1001 from row 1", 4096, 1001, 8, full(1001, 60_000), "rows"),
        ("C=1024, c0 > 0", 4096, 1024, 8, late, None),
    ]


def phase_k1_shapes(torch, np, fg, narrow, dev):
    """K1 raw and its three decode variants against the plain twin at
    k1_shape_cases' shapes over every fn, ops sum / count / stddev (sumsq:
    the largest accumulator); narrow K1 bit for bit against K1 raw on the
    decoded block (a view from row 1: both from row 1). Returns (checks,
    bit-exact checks, max |diff|)."""
    from filodb_tpu_torch.ops import decodereg
    checks = exact = 0
    worst = 0.0
    for i, (name, S, C, G, out_ts, view) in enumerate(
            k1_shape_cases(np, fg)):
        T = len(out_ts)
        Tp = -(-T // 128) * 128
        assert fg.fusable(S, C, T, G), name
        gids = torch.randint(0, G, (S,), device=dev, dtype=torch.int32,
                             generator=torch.Generator(device=dev)
                             .manual_seed(700 + i))
        blocks = []
        integer = i % 2 == 0
        # "rows": one row more, then the view from row 1
        S1 = S + 1 if view == "rows" else S
        if view == "columns":
            val, n = make_block(torch, S, C + 1, integer, 600 + i, dev)
            val, n = val[:, 1:], torch.clamp(n, max=C)
            assert val.stride(0) % 4 != 0
        else:
            val, n = make_block(torch, S1, C, integer, 600 + i, dev)
            val, n = val[S1 - S:], n[S1 - S:]
        blocks.append(("raw", (val,), n, None))
        if view != "columns":
            for kind in NARROW_KINDS:
                ops, kn, dec = narrow_block_dev(torch, narrow, kind, S1, C,
                                                650 + i, dev)
                ops = tuple(o[S1 - S:] for o in ops)
                if view == "rows":
                    assert ops[0].data_ptr() % 16 != 0, (name, kind)
                blocks.append((kind, ops, kn[S1 - S:], dec[S1 - S:]))
        for kind, ops, n, dec in blocks:
            full = decodereg.variant(kind).full_columns
            for fn in FNS:
                fk = "window" if fn in fg.FUSED_WINDOW_FNS else "rate"
                band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
                    C, Tp, out_ts.tobytes(), WINDOW_MS, 0, INTERVAL_MS, fk,
                    full, dev)
                if "c0 > 0" in name and not full:
                    assert 0 < c0 and c0 + Ca <= C, (name, kind, c0, Ca)
                plain = {sq: fg.fused_grid_aggregate_plain(
                    fn, sq, WINDOW_MS, INTERVAL_MS, ops[0], n, gids, band,
                    ohlo, lo, hi, rel, G, c0, Ca, kind, ops[1:])
                    for sq in (False, True)}
                for op in ("sum", "count", "stddev"):
                    got = fg.fused_grid_aggregate(
                        op, fn, ops[0], n, gids, G, out_ts, WINDOW_MS, 0,
                        INTERVAL_MS,
                        narrow=None if kind == "raw" else (kind, ops))
                    ref = fg.PaddedPartials(plain[op == "stddev"], op, G,
                                            T).resolve()
                    ex = {"count"} | ({"sum"} if fn == "count_over_time" or (
                        kind == "raw" and integer and fn == "sum_over_time")
                        else set())
                    worst = max(worst, compare_parts(
                        got, ref, ex, f"{name} {kind} {fn} {op}"))
                    checks += 1
                if dec is not None:
                    a = fg.fused_grid_kernel(fn, True, WINDOW_MS, INTERVAL_MS,
                                             ops[0], n, gids, lo, hi, rel, G,
                                             c0, Ca, kind, ops[1:])
                    b = fg.fused_grid_kernel(fn, True, WINDOW_MS, INTERVAL_MS,
                                             dec, n, gids, lo, hi, rel, G, c0,
                                             Ca)
                    assert same_outputs(a, b), (name, kind, fn,
                                                "narrow != raw on the decode")
                    exact += 1
        del blocks, val
    torch.cuda.synchronize()
    return checks, exact, worst


def quant16_scale_rows(np, C=64):
    """[R, C] f32 rows whose spans lie near, not at, 65535 * 2^k for k in
    [-20, 20]: a few ulps either side, and integer multiples of 2^k one step
    either side of 65535 of them (the encoder's scale = 2^ceil(log2(span /
    65535)) turns on exactly those spans)."""
    rows = []
    rng = np.random.default_rng(21)
    frac = np.linspace(0.0, 1.0, C)
    for k in range(-20, 21):
        unit = 2.0 ** k
        for ulps in (-3, -1, 1, 3):
            span = np.float32(65535.0 * unit)
            toward = np.float32(np.copysign(np.inf, ulps))
            for _ in range(abs(ulps)):
                span = np.nextafter(span, toward)
            vmin = rng.integers(-1000, 1000) * unit
            rows.append(vmin + frac * np.float64(span))
        for steps in (65534, 65536):
            q = np.sort(rng.integers(0, steps + 1, C))
            q[0], q[-1] = 0, steps
            rows.append(rng.integers(-1000, 1000) * unit + q * unit)
    return np.asarray(rows, np.float32)


def phase_quant16_scale(torch, np, narrow, dev):
    """The quant16 encoder on the card against the same encoder on the CPU,
    over quant16_scale_rows: each device's ok rows must decode bit for bit
    (the encoder's contract), and the two devices' blocks, vmin, scale and
    ok rows are compared. Returns (rows, rows whose encoding differs
    between the devices, ok rows on the card, ok rows on the CPU)."""
    from filodb_tpu_torch.ops import decodereg
    val = quant16_scale_rows(np)
    R, C = val.shape
    n = np.full(R, C, np.int32)
    outs = {}
    for d in (dev, "cpu"):
        q, vmin, scale, ok = narrow.build_narrow(
            torch.from_numpy(val).to(d), torch.from_numpy(n).to(d))
        dec = decodereg.variant("quant16").decode(q, vmin[:, None],
                                                  scale[:, None])
        good = (dec == torch.from_numpy(val).to(d)).all(dim=1)
        assert bool((good | ~ok).all()), (d, "an ok row does not decode")
        outs[d] = [t.cpu().numpy() for t in (q, vmin, scale, ok)]
    same = np.ones(R, bool)
    for a, b in zip(outs[dev], outs["cpu"]):
        same &= (a == b).reshape(R, -1).all(axis=1)
    return R, int((~same).sum()), int(outs[dev][3].sum()), \
        int(outs["cpu"][3].sum())


def compare_result(np, q, g, r, exact: bool, rtol: float = 1e-5,
                   route: str | None = "local") -> None:
    """One answer on the card against the CPU engine's: keys in order,
    steps, bucket tops, shape, NaN and Inf placement, values (bit for bit
    where ``exact``, else ``rtol`` of the largest finite magnitude), the
    QueryStats counters and the route (before its implementation bracket;
    ``route`` None: any route, the same on both)."""
    assert [k.labels for k in g.matrix.keys] == \
        [k.labels for k in r.matrix.keys], q
    assert np.array_equal(g.matrix.out_ts, r.matrix.out_ts), q
    gl, rl = g.matrix.bucket_les, r.matrix.bucket_les
    assert (gl is None) == (rl is None) and (
        gl is None or np.array_equal(gl, rl)), (q, "bucket tops")
    gv = np.asarray(g.matrix.values, np.float64)
    rv = np.asarray(r.matrix.values, np.float64)
    assert gv.shape == rv.shape, (q, gv.shape, rv.shape)
    assert (np.isnan(gv) == np.isnan(rv)).all(), (q, "NaN placement")
    assert (np.isinf(gv) == np.isinf(rv)).all(), (q, "Inf placement")
    if exact:
        assert np.array_equal(gv, rv, equal_nan=True), (q, "not exact")
    else:
        fin = np.isfinite(rv)
        scale = float(np.abs(rv[fin]).max(initial=0.0))
        np.testing.assert_allclose(gv[fin], rv[fin], rtol=rtol,
                                   atol=rtol * scale, err_msg=q)
        assert (gv[np.isinf(rv)] == rv[np.isinf(rv)]).all(), q
    for k in ("fused_kernels", "blocks_narrow", "blocks_raw",
              "series_matched", "subquery_inner_cells"):
        assert getattr(g.stats, k) == getattr(r.stats, k), (q, k)
    gp, rp = g.exec_path.split("[")[0], r.exec_path.split("[")[0]
    assert gp == rp and route in (None, gp), (q, g.exec_path, r.exec_path)


def compare_engines(np, got, ref_engine, queries, start, end, step):
    """Each query's answer on the card against the CPU engine's
    (compare_result at rtol 1e-5), every value finite."""
    for q in queries:
        compare_result(np, q, got[q], ref_engine.query_range(q, start, end,
                                                             step), False)
        gv = np.asarray(got[q].matrix.values, np.float64)
        assert np.isfinite(gv[~np.isnan(gv)]).all(), q


def ingest_small(RecordBuilder, GAUGE, shards, np):
    """~4096 series x 100 samples through the real ingest path; a sixteenth
    of the series start 20 cells late (a churned cohort)."""
    rng = np.random.default_rng(3)
    n_series, n_samples = 4096, 100
    per = 512
    for c in range(n_series // per):
        b = RecordBuilder(GAUGE)
        for s in range(c * per, (c + 1) * per):
            late = 20 if s % 16 == 5 else 0
            k = n_samples - late
            ts = BASE_TS + (late + np.arange(k, dtype=np.int64)) * INTERVAL_MS
            vals = np.cumsum(rng.exponential(5.0, k))
            b.add_batch({"_metric_": "m", "host": f"h{s % 8}", "inst": f"i{s}"},
                        ts, vals)
        cont = b.build()
        for sh in shards:
            sh.ingest(cont)
    for sh in shards:
        sh.flush()


def phase_small(torch, np, fg, pkg, devs=("cuda", "cpu")):
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    engines = {}
    shards = []
    for dev in devs:
        ms = TimeSeriesMemStore(device=dev)
        shards.append(ms.setup("p", GAUGE, 0, StoreConfig(
            max_series_per_shard=4096, samples_per_series=128,
            flush_batch_size=10**9, device=dev)))
        engines[dev] = QueryEngine(ms, "p", device=dev)
    ingest_small(RecordBuilder, GAUGE, shards, np)
    kind, _ = shards[0].store.grid_cohorts()
    assert kind == "mixed", kind
    start, end, step = BASE_TS + 300_000, BASE_TS + 990_000, 30_000
    reset_k1(fg)
    got = {q: engines[devs[0]].query_range(q, start, end, step)
           for q in SLICE_QUERIES}
    launches = fg.fused_grid_kernel.launches
    compare_engines(np, got, engines[devs[1]], SLICE_QUERIES, start, end,
                    step)
    fused = sum(got[q].stats.fused_kernels for q in SLICE_QUERIES)
    assert launches == fused == 5, (launches, fused)
    return launches


def ingest_small_narrow(RecordBuilder, GAUGE, shards, np, kind):
    """4096 series x 100 samples of ``kind``'s shape through the real
    ingest path: a sixteenth start 20 cells late (a churned cohort), one in
    8 is continuous (no variant carries it: the cohort pool)."""
    rng = np.random.default_rng(4)
    n_series, n_samples, per = 4096, 100, 512
    for c in range(n_series // per):
        b = RecordBuilder(GAUGE)
        for s in range(c * per, (c + 1) * per):
            late = 20 if s % 16 == 5 else 0
            k = n_samples - late
            ts = BASE_TS + (late + np.arange(k, dtype=np.int64)) * INTERVAL_MS
            if s % 8 == 3:
                vals = np.cumsum(rng.exponential(5.0, k))
            elif kind == "delta8":
                vals = (np.cumsum(rng.integers(0, 9, k))
                        + float(rng.integers(0, 1 << 20)))
            elif kind == "delta16":
                vals = np.cumsum(rng.integers(200, 3000, k)).astype(np.float64)
            else:
                vals = 1000.0 + 0.5 * np.cumsum(rng.integers(0, 3, k))
            b.add_batch({"_metric_": "m", "host": f"h{s % 8}", "inst": f"i{s}"},
                        ts, vals)
        cont = b.build()
        for sh in shards:
            sh.ingest(cont)
    for sh in shards:
        sh.flush()


def phase_small_narrow(torch, np, fg, pkg, devs=("cuda", "cpu")):
    """The slice's queries on "gauge" stores of each kind, card against
    CPU; returns K1's launches by kind over the main-path runs."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    start, end, step = BASE_TS + 300_000, BASE_TS + 990_000, 30_000
    launched = {}
    for kind in NARROW_KINDS:
        engines, shards = {}, []
        for dev in devs:
            ms = TimeSeriesMemStore(device=dev)
            shards.append(ms.setup("p", GAUGE, 0, StoreConfig(
                max_series_per_shard=4096, samples_per_series=128,
                flush_batch_size=10**9, compressed_residency="gauge",
                device=dev)))
            engines[dev] = QueryEngine(ms, "p", device=dev)
        ingest_small_narrow(RecordBuilder, GAUGE, shards, np, kind)
        for sh in shards:
            nd = sh.store.narrow_operands()
            assert nd is not None and nd[0] == kind, (kind, nd and nd[0])
            assert int((~nd[2][:4096]).sum()) == 512, int((~nd[2]).sum())
        reset_k1(fg)
        got = {q: engines[devs[0]].query_range(q, start, end, step)
               for q in SLICE_QUERIES}
        launched[kind] = fg.fused_grid_kernel.launches_by_kind[kind]
        fused = sum(got[q].stats.fused_kernels for q in SLICE_QUERIES)
        assert launched[kind] == fg.fused_grid_kernel.launches == fused == 5, \
            (kind, launched[kind], fused)
        compare_engines(np, got, engines[devs[1]], SLICE_QUERIES, start, end,
                        step)
        # K1 on the store's narrow block against K1 raw on its decode
        st = shards[0].store
        _kind, ops, ok = st.narrow_operands()
        dev = st.device
        n = torch.where(torch.from_numpy(ok).to(dev), st.n, 0).contiguous()
        gids = fg.zero_gids(st.S, dev)
        out_ts = np.arange(start, end + 1, step, dtype=np.int64) - BASE_TS
        Tp = -(-len(out_ts) // 128) * 128
        from filodb_tpu_torch.ops import decodereg
        _b, _o, lo, hi, rel, c0, Ca = fg.device_operands(
            st.C, Tp, out_ts.tobytes(), WINDOW_MS, 0, INTERVAL_MS, "rate",
            decodereg.variant(kind).full_columns, dev)
        a = fg.fused_grid_kernel("rate", True, WINDOW_MS, INTERVAL_MS,
                                 ops[0], n, gids, lo, hi, rel, 8, c0, Ca,
                                 kind, ops[1:])
        b = fg.fused_grid_kernel("rate", True, WINDOW_MS, INTERVAL_MS,
                                 st.value_block(), n, gids, lo, hi, rel, 8,
                                 c0, Ca)
        assert same_outputs(a, b), (kind, "store: narrow != raw on the decode")
    return launched


def phase_scale(torch, np, fg, card, engine, shard, reg_s):
    log(f"scale: registered {NUM_SERIES} series in {reg_s:.1f} s; store "
        f"val {tuple(shard.store.val.shape)} f32, ts "
        f"{tuple(shard.store.ts.shape)} i64 on the card")
    variants = range_variants(shard)
    start, end = variants[0]
    q = "sum(rate(m[5m]))"
    for s, e in variants:                      # first calls: load + warm
        engine.query_range(q, s, e, STEP_MS)
    # the main path: counts from 0, read right after
    reset_k1(fg)
    results, lat = [], []
    for i in range(8 + 11):
        s, e = variants[i % 8]
        t0 = time.perf_counter()
        r = engine.query_range(q, s, e, STEP_MS)
        lat.append((time.perf_counter() - t0) * 1000)
        if i < 8:
            results.append(r)
    n_queries = 8 + 11
    launches = fg.fused_grid_kernel.launches
    assert launches == fg.fused_grid_kernel.launches_by_kind["raw"] \
        == n_queries, (launches, n_queries)
    p50 = float(np.percentile(lat[8:], 50))
    stages = {k: round(v, 3) for k, v in r.stats.stage_ms.items()}
    from filodb_tpu_torch.core.filters import Equals
    sel_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pids = shard.part_ids_from_filters([Equals("_metric_", "m")],
                                           start, end)
        sel_ms.append((time.perf_counter() - t0) * 1000)
    assert len(pids) == NUM_SERIES
    sel_p50 = float(np.percentile(sel_ms, 50))

    st = shard.store
    gids = fg.zero_gids(st.S, st.val.device)
    worst = 0.0
    for (s, e), r in zip(variants, results):
        out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
        vals = np.asarray(r.matrix.values)
        assert vals.shape == (1, len(out_ts)) and np.isfinite(vals).all(), \
            vals.shape
        T = len(out_ts)
        Tp = -(-T // 128) * 128
        ops = fg.device_operands(CAPACITY, Tp, out_ts.tobytes(), WINDOW_MS,
                                  BASE_TS, INTERVAL_MS, "rate", False,
                                  st.val.device)
        band, ohlo, lo, hi, rel, c0, Ca = ops
        plain = fg.PaddedPartials(fg.fused_grid_aggregate_plain(
            "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, band,
            ohlo, lo, hi, rel, 8, c0, Ca), "sum", 8, T).resolve()
        kern = fg.PaddedPartials(fg.fused_grid_kernel(
            "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, lo,
            hi, rel, 8, c0, Ca), "sum", 8, T).resolve()
        worst = max(worst, compare_parts(kern, plain, {"count"},
                                         f"scale {s}-{e}"))
        ref = plain["sum"][:1]
        np.testing.assert_allclose(vals, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))

    # timing at variant 0's operands (the full 2 h range: Ca = C = 768)
    s, e = variants[0]
    out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
    T = len(out_ts)
    Tp = -(-T // 128) * 128
    band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
        CAPACITY, Tp, out_ts.tobytes(), WINDOW_MS, BASE_TS, INTERVAL_MS,
        "rate", False, st.val.device)
    k_ms = cuda_ms(lambda: fg.fused_grid_kernel(
        "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, lo, hi,
        rel, 8, c0, Ca), reps=20)
    p_ms = cuda_ms(lambda: fg.fused_grid_aggregate_plain(
        "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, band,
        ohlo, lo, hi, rel, 8, c0, Ca), reps=3, warm=1)
    key, bw, f32 = peaks_for(card)
    S = st.S
    nbytes, flops, bound_ms, bound_by = k1_raw_bound(np, card, S, Ca, T, lo,
                                                     hi)
    # the 30-minute panel's operands (bench.measure's sub-range, variant 0)
    pts = np.arange(e - SUB_RANGE_MS, e + 1, STEP_MS, dtype=np.int64)
    pT = len(pts)
    pband, pohlo, plo, phi, prel, pc0, pCa = fg.device_operands(
        CAPACITY, -(-pT // 128) * 128, pts.tobytes(), WINDOW_MS, BASE_TS,
        INTERVAL_MS, "rate", False, st.val.device)
    worst = max(worst, compare_parts(
        fg.PaddedPartials(fg.fused_grid_kernel(
            "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, plo,
            phi, prel, 8, pc0, pCa), "sum", 8, pT).resolve(),
        fg.PaddedPartials(fg.fused_grid_aggregate_plain(
            "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, pband,
            pohlo, plo, phi, prel, 8, pc0, pCa), "sum", 8, pT).resolve(),
        {"count"}, "scale 30-minute panel"))
    panel_ms = cuda_ms(lambda: fg.fused_grid_kernel(
        "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, plo, phi,
        prel, 8, pc0, pCa), reps=20)
    pbytes, pflops, pbound_ms, pbound_by = k1_raw_bound(np, card, S, pCa, pT,
                                                        plo, phi)
    log(f"scale [{card}]: engine single-query p50 {p50:.3f} ms "
        f"(sum(rate(m[5m])), {T} steps, {n_queries} queries); last query's "
        f"stages (host clock, ms) {stages}; index selection of the "
        f"{NUM_SERIES} series p50 {sel_p50:.3f} ms")
    log(f"scale [{card}]: K1 {k_ms:.4f} ms by CUDA events; plain twin "
        f"{p_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e9:.3f} GB at {key}'s {bw / 1e12:.2f} TB/s, "
        f"{flops / 1e9:.2f} GFLOP at {f32 / 1e12:.0f} TFLOP/s f32)")
    log(f"scale [{card}]: K1 on the 30-minute panel's operands ({pT} steps, "
        f"columns {pc0}+{pCa}) {panel_ms:.4f} ms by CUDA events "
        f"({panel_ms / k_ms:.3f} of the full range's); bound "
        f"{pbound_ms:.4f} ms ({pbound_by}: {pbytes / 1e9:.3f} GB, "
        f"{pflops / 1e9:.2f} GFLOP)")
    log(f"scale [{card}]: library call: none (no single PyTorch call "
        "computes this function)")
    log(f"scale [{card}]: launches per query {launches / n_queries:.2f}; "
        f"K1 vs plain max |diff| {worst:.3g}")
    return dict(launches=launches, max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def k1_raw_bound(np, card, S, Ca, T, lo, hi):
    """(bytes, operations, bound ms, bound_by) of K1 raw over S rows of Ca
    f32 columns for the T steps of ``lo``/``hi`` (device [1, Tp] i32): the
    columns once, n and gid, the step operands, the [2, 8, Tp] output; per
    (row, step) one subtract + max + add per window cell of this data and
    ~30 operations for the extrapolation and the fold."""
    key, bw, f32 = peaks_for(card)
    Tp = lo.shape[-1]
    nbytes = S * Ca * 4 + 2 * S * 4 + 3 * Tp * 4 + 2 * 8 * Tp * 4
    lo_h, hi_h = lo.cpu().numpy()[0, :T], hi.cpu().numpy()[0, :T]
    cells = np.clip(np.minimum(hi_h, NUM_SAMPLES - 1)
                    - np.maximum(lo_h + 1, 1) + 1, 0, None)
    flops = S * float((3 * cells + 30).sum())
    bound_ms = max(nbytes / bw, flops / f32) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / f32 else "operations"
    return nbytes, flops, bound_ms, bound_by


def k3_bound(card, S, C):
    """(bound ms, bound_by, bytes, adds) of K3 over [S, C] f32: the whole
    512-row tiles read once and the (8, 128) output written once, one add
    per element read."""
    key, bw, f32 = peaks_for(card)
    rows = S // 512 * 512
    nbytes = rows * C * 4 + 8 * 128 * 4
    adds = rows * C
    bound_by = "bytes" if nbytes / bw >= adds / f32 else "operations"
    return max(nbytes / bw, adds / f32) * 1e3, bound_by, nbytes, adds


def stream_block(torch, S, C, integer, seed, dev):
    """[S, C] f32 made on the card: small integers (every partial sum an
    integer below 2^24, exact in any order) or bench.py's counters
    (exponential x 5 increments cumulated along each row)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        return torch.randint(0, 8, (S, C), generator=g, device=dev).float()
    inc = torch.empty((S, C), device=dev).exponential_(generator=g)
    return torch.cumsum(inc.mul_(5.0), 1)


def k3_vs_plain(np, sp, val, exact: bool, what: str) -> float:
    """K3 against its plain twin on the same card tensor: bit for bit when
    ``exact``, else within rtol 1e-5 of the largest magnitude. Returns the
    max |diff|."""
    got = sp.stream_probe_kernel(val).cpu().numpy()
    ref = sp.stream_probe_plain(val).cpu().numpy()
    assert got.shape == ref.shape == (8, 128), (what, got.shape)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    if exact:
        assert np.array_equal(got, ref), (what, "not bit-exact",
                                          float(np.abs(got - ref).max()))
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=what)
    return float(np.abs(got - ref).max())


def phase_stream_kernels(torch, np, sp, card, dev):
    """K3 against its plain twin over S x C x data, the tail rows, a
    misaligned view, the refusals; then its times at bench.py's store."""
    worst, checks = 0.0, 0
    for S in (512, 4096, 4196, 65536, NUM_SERIES):
        for C in (128, CAPACITY):
            for integer in (True, False):
                val = stream_block(torch, S, C, integer, 500 + checks, dev)
                worst = max(worst, k3_vs_plain(
                    np, sp, val, integer,
                    f"S={S} C={C} {'integer' if integer else 'counters'}"))
                checks += 1
                del val
    # the 100 rows past the last whole tile are never read: NaN there
    # would poison any sum that read them
    val = stream_block(torch, 4196, CAPACITY, True, 7, dev)
    val[4096:] = float("nan")
    k3_vs_plain(np, sp, val, True, "NaN tail rows")
    assert torch.equal(sp.stream_probe_kernel(val),
                       sp.stream_probe_kernel(val[:4096])), "tail rows read"
    # an odd row stride and a base 4 bytes past 16: scalar loads
    view = stream_block(torch, 4096, CAPACITY + 1, True, 8, dev)[:, 1:]
    assert not sp.vector_loads(view)
    k3_vs_plain(np, sp, view, True, "misaligned view")
    checks += 3
    before = sp.stream_probe_kernel.launches
    for bad, what in ((torch.zeros(512, 128), "a CPU tensor"),
                      (torch.zeros((512, 128), dtype=torch.float16,
                                   device=dev), "float16"),
                      (torch.zeros((512, 64), device=dev), "C = 64")):
        try:
            sp.stream_probe_kernel(bad)
            raise AssertionError(f"K3 accepted {what}")
        except ValueError:
            pass
    assert sp.stream_probe_kernel.launches == before
    del val, view
    # times at bench.py's store shape, on its kind of data
    S, C = NUM_SERIES, CAPACITY
    val = stream_block(torch, S, C, False, 9, dev)
    k_ms = cuda_ms(lambda: sp.stream_probe_kernel(val), reps=20)
    p_ms = cuda_ms(lambda: sp.stream_probe_plain(val), reps=3, warm=1)
    lib_ms = cuda_ms(lambda: torch.sum(val, 0), reps=20)
    del val
    torch.cuda.synchronize()
    bound_ms, bound_by, nbytes, adds = k3_bound(card, S, C)
    key, bw, f32 = peaks_for(card)
    log(f"stream [{card}]: K3 {k_ms:.4f} ms by CUDA events at {S} x {C} "
        f"({nbytes / 1e9 / k_ms:.3f} TB/s); plain twin {p_ms:.3f} ms; "
        f"library call torch.sum(val, 0) {lib_ms:.4f} ms "
        f"({lib_ms / k_ms:.3f}x K3's time); bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB at {key}'s "
        f"{bw / 1e12:.2f} TB/s, {adds / 1e9:.2f} G adds at "
        f"{f32 / 1e12:.0f} TFLOP/s f32)")
    assert k_ms >= bound_ms, (k_ms, bound_ms, "K3 beat its bound: bytes "
                              "skipped")
    return dict(checks=checks, max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_entry(torch, np, fg, dev):
    """entry() on ``dev`` against the same step on the CPU (the plain
    twin); K1 launches once. Returns (launches, max |diff|)."""
    from filodb_tpu_torch.entry import entry
    fn, args = entry(dev)
    fn_cpu, args_cpu = entry("cpu")
    reset_k1(fg)
    got = fn(*args).cpu().numpy()
    launches = fg.fused_grid_kernel.launches
    ref = fn_cpu(*args_cpu).numpy()
    assert launches == 1, launches
    assert got.shape == ref.shape == (1, 17) and np.isfinite(got).all(), \
        got.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    return launches, float(np.abs(got - ref).max())


def phase_bench(np, fg, sp, bench, card, engine, shard, reg_s, k1_ms):
    """The port's bench on phase 4's engine, in this process: the same
    ``bench.measure`` that ``python3 -m filodb_tpu_torch.bench`` runs after
    its own build_engine. Returns (K1 launches, K3 launches, result)."""
    reset_k1(fg)
    sp.stream_probe_kernel.launches = 0
    t0 = time.perf_counter()
    res = bench.measure(engine, shard, reg_s)
    secs = time.perf_counter() - t0
    k1 = fg.fused_grid_kernel.launches
    k3 = sp.stream_probe_kernel.launches
    # one K1 per query answered: 8 warm, 10 single, the pool's warm-up and
    # the rounds; and one per pipelined dispatch of the two marginals
    nv = bench.NUM_VARIANTS
    queries = nv + 10 + bench.POOL_WORKERS + bench.ROUNDS * bench.NUM_QUERIES
    dispatches = 2 * (nv + bench.MARGINAL_REPS * sum(bench.PIPELINE_DEPTHS))
    assert k1 == fg.fused_grid_kernel.launches_by_kind["raw"] \
        == queries + dispatches, (k1, queries, dispatches)
    assert k3 > 0, k3
    d = res["detail"]
    assert res["metric"] == bench.METRIC and d["series"] == NUM_SERIES
    numbers = [("value", res["value"]), ("vs_baseline", res["vs_baseline"])]
    for k, v in d.items():
        if isinstance(v, list):
            numbers += [(k, x) for x in v]
        elif not isinstance(v, str):
            numbers.append((k, v))
    for k, v in numbers:
        assert isinstance(v, (int, float)) and np.isfinite(v) and v > 0, (k, v)
    bound_ms = k3_bound(card, *shard.store.val.shape)[0]
    for k in ("hbm_stream_pass_ms", "hbm_stream_pass_device_ms"):
        assert d[k] >= bound_ms, (k, d[k], bound_ms)
    log(f"bench result: {json.dumps(res)}")
    busy = [k1_ms / r for r in d["per_query_ms_rounds"]]
    single, full = d["single_query_p50_ms"], d["device_marginal_ms_per_query"]
    sub = d["device_marginal_ms_subrange_30m"]
    log(f"bench [{card}]: {bench.ROUNDS} x {bench.NUM_QUERIES} queries from "
        f"{bench.POOL_WORKERS} threads, every answer equal to its variant's; "
        f"per query {res['value']:.4f} ms best, {d['per_query_ms_p50']:.4f} "
        f"p50; single-query p50 {single:.4f} ms ({single / res['value']:.3f}x "
        f"the best round's per-query time); device marginal {full:.4f} ms, "
        f"the 30-minute panel's {sub:.4f} ms ({sub / full:.3f} of it); card "
        f"busy share per round (K1 {k1_ms:.4f} ms x queries / wall) "
        f"{[round(b, 4) for b in busy]}; K1 launches {k1} ({queries} queries "
        f"+ {dispatches} pipelined dispatches), K3 launches {k3}; baseline "
        f"proxy {d['baseline_method']} in {d['baseline_proxy_s']:.1f} s; "
        f"{secs:.1f} s in all")
    return k1, k3, res


def trace_concurrent_round(torch, bench, card, engine, shard):
    """One more concurrent round (NUM_QUERIES from the pool) under
    torch.profiler, device activity only: the card's busy share is the
    device time of every kernel and copy in the round over the round's wall
    time (which the trace itself lengthens a little). Returns the share, or
    None where the trace shows no device time."""
    from concurrent.futures import ThreadPoolExecutor

    from torch.profiler import ProfilerActivity, profile
    run = bench.query_runner(engine, bench.range_variants(shard))
    with ThreadPoolExecutor(max_workers=bench.POOL_WORKERS) as pool:
        list(pool.map(run, range(bench.POOL_WORKERS)))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            list(pool.map(run, range(bench.NUM_QUERIES)))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation) / 1e3
    top = sorted(((e.self_device_time_total / 1e3, e.key) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 reverse=True)[:5]
    if dev_ms <= 0:
        log(f"bench trace [{card}]: no device time in the trace; busy share "
            f"not measured (round wall {wall_ms:.1f} ms)")
        return None
    share = dev_ms / wall_ms
    log(f"bench trace [{card}]: one traced round of {bench.NUM_QUERIES} "
        f"queries from {bench.POOL_WORKERS} threads: device time "
        f"{dev_ms:.3f} ms over wall {wall_ms:.3f} ms, busy share "
        f"{share:.4f}; largest device rows (ms) "
        f"{[(round(t, 3), k[:60]) for t, k in top]}")
    return share


def install_narrow_scale(torch, shard, kind, dev):
    """Write ``kind``'s data at bench.py's shape into the store on the card
    from a seeded torch.Generator: delta8 counters (integer anchors below
    2^20, integer increments in [0, 8]), quant16 gauges (anchors 1000 +
    [0, 1000), steps of 0, 0.5 or 1), delta16 (integer increments in
    [0, 2000)); one row in 16 gets a uniform [0, 1) fraction on every
    increment (no variant carries it: the cohort pool). A compressed store
    rehydrates first, as an append would."""
    st = shard.store
    g = torch.Generator(device=dev).manual_seed(11 + NARROW_KINDS.index(kind))
    shape = (DATA_BATCH, NUM_SAMPLES)

    def ints(lo, hi, shp):
        return torch.randint(lo, hi, shp, generator=g, device=dev).float()
    with shard.lock:
        st._rehydrate()
        for r0 in range(0, NUM_SERIES, DATA_BATCH):
            if kind == "delta8":
                inc, base = ints(0, 9, shape), ints(0, 1 << 20, (DATA_BATCH, 1))
            elif kind == "quant16":
                inc = 0.5 * ints(0, 3, shape)
                base = 1000.0 + ints(0, 1000, (DATA_BATCH, 1))
            else:
                inc, base = ints(0, 2000, shape), ints(0, 1 << 20, (DATA_BATCH, 1))
            frac = torch.empty(shape, device=dev).uniform_(generator=g)
            rows = torch.arange(r0, r0 + DATA_BATCH, device=dev)
            inc = torch.where((rows % 16 == 15)[:, None], inc + frac, inc)
            st.val[r0:r0 + DATA_BATCH, :NUM_SAMPLES] = base + torch.cumsum(inc, 1)
        st.val[:, NUM_SAMPLES:] = 0.0
        st.stats.samples_appended += NUM_SERIES * NUM_SAMPLES
    torch.cuda.synchronize()


def phase_scale_narrow(torch, np, fg, card, shard, engine, kind, dev="cuda"):
    """One decode variant at bench.py's shape: raw answers first, then the
    flush compresses and the main path runs on the narrow store."""
    from filodb_tpu_torch.ops import decodereg
    install_narrow_scale(torch, shard, kind, dev)
    st = shard.store
    variants = range_variants(shard)
    q = "sum(rate(m[5m]))"
    # the raw-residency answers: the same store before it compresses
    shard.config.compressed_residency = "off"
    raw_ans = [np.asarray(engine.query_range(q, s, e, STEP_MS).matrix.values)
               for s, e in variants]
    raw_bytes = st.resident_sample_bytes()
    shard.config.compressed_residency = "gauge"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shard.flush()
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    nd = st.narrow_operands()
    assert nd is not None and nd[0] == kind, (kind, nd and nd[0])
    _k, ops, ok = nd
    assert st.val is None and st.ts is None
    assert int((~ok).sum()) == NUM_SERIES // 16, int((~ok).sum())
    res_bytes = st.resident_sample_bytes()
    for s, e in variants:                      # first calls: warm
        engine.query_range(q, s, e, STEP_MS)
    # the main path: counts from 0, read right after
    reset_k1(fg)
    results, lat = [], []
    for i in range(8 + 11):
        s, e = variants[i % 8]
        t0 = time.perf_counter()
        r = engine.query_range(q, s, e, STEP_MS)
        lat.append((time.perf_counter() - t0) * 1000)
        if i < 8:
            results.append(r)
    n_queries = 8 + 11
    launches = fg.fused_grid_kernel.launches_by_kind[kind]
    assert launches == fg.fused_grid_kernel.launches == n_queries, \
        (kind, launches, fg.fused_grid_kernel.launches)
    assert all(r.stats.blocks_narrow == 1 for r in results)
    p50 = float(np.percentile(lat[8:], 50))

    full = decodereg.variant(kind).full_columns
    n = torch.where(torch.from_numpy(ok).to(st.device), st.n, 0).contiguous()
    gids = fg.zero_gids(st.S, st.device)
    worst = 0.0
    for i, ((s, e), r, want) in enumerate(zip(variants, results, raw_ans)):
        out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
        vals = np.asarray(r.matrix.values)
        assert vals.shape == want.shape == (1, len(out_ts)), vals.shape
        assert np.isfinite(vals).all()
        np.testing.assert_allclose(vals, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=f"{kind} vs raw residency")
        if i not in (0, len(variants) - 1):
            # K1 against its plain twin (~3 s a call) at the widest and the
            # narrowest range only: the depth was cut from all 8 to keep
            # the script's budget with phases 11a/11b
            continue
        T = len(out_ts)
        Tp = -(-T // 128) * 128
        band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
            CAPACITY, Tp, out_ts.tobytes(), WINDOW_MS, BASE_TS, INTERVAL_MS,
            "rate", full, st.device)
        plain = fg.PaddedPartials(fg.fused_grid_aggregate_plain(
            "rate", False, WINDOW_MS, INTERVAL_MS, ops[0], n, gids, band, ohlo,
            lo, hi, rel, 8, c0, Ca, kind, ops[1:]), "sum", 8, T).resolve()
        kern = fg.PaddedPartials(fg.fused_grid_kernel(
            "rate", False, WINDOW_MS, INTERVAL_MS, ops[0], n, gids, lo, hi,
            rel, 8, c0, Ca, kind, ops[1:]), "sum", 8, T).resolve()
        worst = max(worst, compare_parts(kern, plain, {"count"},
                                         f"{kind} scale {s}-{e}"))

    # timing at variant 0's operands (the full 2 h range: Ca = C = 768),
    # beside K1 raw on the decoded block, bit for bit the same partials
    s, e = variants[0]
    out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
    T = len(out_ts)
    Tp = -(-T // 128) * 128
    band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
        CAPACITY, Tp, out_ts.tobytes(), WINDOW_MS, BASE_TS, INTERVAL_MS,
        "rate", full, st.device)
    dec = st.value_block()
    a = fg.fused_grid_kernel("rate", True, WINDOW_MS, INTERVAL_MS, ops[0], n,
                             gids, lo, hi, rel, 8, c0, Ca, kind, ops[1:])
    b = fg.fused_grid_kernel("rate", True, WINDOW_MS, INTERVAL_MS, dec, n,
                             gids, lo, hi, rel, 8, c0, Ca)
    assert same_outputs(a, b), (kind, "scale: narrow != raw on the decode")
    k_ms = cuda_ms(lambda: fg.fused_grid_kernel(
        "rate", False, WINDOW_MS, INTERVAL_MS, ops[0], n, gids, lo, hi, rel,
        8, c0, Ca, kind, ops[1:]), reps=20)
    raw_ms = cuda_ms(lambda: fg.fused_grid_kernel(
        "rate", False, WINDOW_MS, INTERVAL_MS, dec, n, gids, lo, hi, rel, 8,
        c0, Ca), reps=20)
    panel = {}
    if not full:
        # quant16 slices the active columns: the 30-minute panel's operands
        # (phase 4's, bench.measure's sub-range at variant 0's end) against
        # the plain twin, bit for bit K1 raw on the decoded block, and timed
        # beside it
        pts = np.arange(e - SUB_RANGE_MS, e + 1, STEP_MS, dtype=np.int64)
        pT = len(pts)
        pband, pohlo, plo, phi, prel, pc0, pCa = fg.device_operands(
            CAPACITY, -(-pT // 128) * 128, pts.tobytes(), WINDOW_MS, BASE_TS,
            INTERVAL_MS, "rate", False, st.device)
        assert pc0 > 0 and pCa < CAPACITY, (pc0, pCa)
        pa = fg.fused_grid_kernel("rate", True, WINDOW_MS, INTERVAL_MS,
                                  ops[0], n, gids, plo, phi, prel, 8, pc0,
                                  pCa, kind, ops[1:])
        pb = fg.fused_grid_kernel("rate", True, WINDOW_MS, INTERVAL_MS, dec,
                                  n, gids, plo, phi, prel, 8, pc0, pCa)
        assert same_outputs(pa, pb), (kind, "panel: narrow != raw on the "
                                      "decode")
        worst = max(worst, compare_parts(
            fg.PaddedPartials(pa[:2], "sum", 8, pT).resolve(),
            fg.PaddedPartials(fg.fused_grid_aggregate_plain(
                "rate", False, WINDOW_MS, INTERVAL_MS, ops[0], n, gids,
                pband, pohlo, plo, phi, prel, 8, pc0, pCa, kind, ops[1:]),
                "sum", 8, pT).resolve(), {"count"}, f"{kind} panel"))
        panel = dict(panel_ms=cuda_ms(lambda: fg.fused_grid_kernel(
            "rate", False, WINDOW_MS, INTERVAL_MS, ops[0], n, gids, plo, phi,
            prel, 8, pc0, pCa, kind, ops[1:]), reps=20),
            panel_raw_ms=cuda_ms(lambda: fg.fused_grid_kernel(
                "rate", False, WINDOW_MS, INTERVAL_MS, dec, n, gids, plo, phi,
                prel, 8, pc0, pCa), reps=20))
        log(f"narrow scale {kind} [{card}]: the 30-minute panel ({pT} steps,"
            f" columns {pc0}+{pCa}): K1-{kind} {panel['panel_ms']:.4f} ms, "
            f"K1-raw on the decoded block {panel['panel_raw_ms']:.4f} ms by "
            f"CUDA events (same partials bit for bit)")
        del pa, pb
    del dec, a, b
    # one call of the plain twin (~3 s a kind): the yardstick's depth was
    # cut from 3 timed calls after a warm one to keep the script's budget
    # with phases 11a/11b
    p_ms = cuda_ms(lambda: fg.fused_grid_aggregate_plain(
        "rate", False, WINDOW_MS, INTERVAL_MS, ops[0], n, gids, band, ohlo,
        lo, hi, rel, 8, c0, Ca, kind, ops[1:]), reps=1, warm=0)
    key, bw, f32 = peaks_for(card)
    S = st.S
    # the block's columns once, n, gid and the row operands, the step
    # operands, the [2, 8, Tp] output
    nbytes = (S * Ca * ops[0].element_size() + 2 * S * 4
              + S * 4 * (len(ops) - 1) + 3 * Tp * 4 + 2 * 8 * Tp * 4)
    lo_h, hi_h = lo.cpu().numpy()[0, :T], hi.cpu().numpy()[0, :T]
    cells = np.clip(np.minimum(hi_h, NUM_SAMPLES - 1)
                    - np.maximum(lo_h + 1, 1) + 1, 0, None)
    # as the raw bound, plus the decode: 3 operations a cell for quant16,
    # 2 (a scan add and the anchor add) for the delta variants
    flops = S * float((3 * cells + 30).sum()) \
        + S * Ca * (3 if kind == "quant16" else 2)
    bound_ms = max(nbytes / bw, flops / f32) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / f32 else "operations"
    log(f"narrow scale {kind} [{card}]: engine single-query p50 {p50:.3f} ms "
        f"(sum(rate(m[5m])), {T} steps, {n_queries} queries, "
        f"{NUM_SERIES // 16} pool rows); last query's stages (host clock, "
        f"ms) { {k: round(v, 3) for k, v in r.stats.stage_ms.items()} }")
    log(f"narrow scale {kind} [{card}]: K1-{kind} {k_ms:.4f} ms by CUDA "
        f"events, K1-raw on the decoded block {raw_ms:.4f} ms (same "
        f"partials bit for bit); plain twin {p_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB at {key}'s "
        f"{bw / 1e12:.2f} TB/s, {flops / 1e9:.2f} GFLOP at "
        f"{f32 / 1e12:.0f} TFLOP/s f32)")
    log(f"narrow scale {kind} [{card}]: launches per query "
        f"{launches / n_queries:.2f}; K1 vs plain max |diff| {worst:.3g}; "
        f"resident sample bytes {raw_bytes / 1e9:.3f} GB raw -> "
        f"{res_bytes / 1e9:.3f} GB ({raw_bytes / res_bytes:.2f}x); "
        f"compressed at flush in {comp_s:.2f} s; library call: none")
    return dict(launches=launches, max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms, bound_by=bound_by, raw_ms=raw_ms, **panel)


def hist_block_dev(torch, S, C, B, wide, seed, dev):
    """Integer cumulative bucket counts [S, C, B] f32 made on the card, with
    short rows and two rows of fewer than two samples: quiet (dd fits i8)
    or, with ``wide``, alternating bursts (dd needs i16)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    inc = torch.poisson(torch.full((S, C, B), 3.0 if wide else 0.3,
                                   device=dev), generator=g)
    if wide:
        inc[:, ::2, :] += 150.0
    val = torch.cumsum(torch.cumsum(inc, 1), 2)
    n = torch.full((S,), C, dtype=torch.int32, device=dev)
    short = torch.randint(0, 4, (S,), generator=g, device=dev) == 0
    n = torch.where(short, torch.randint(2, C, (S,), generator=g, device=dev,
                                         dtype=torch.int32), n)
    n[3], n[4] = 0, 1
    return val, n


def hist_operands_dev(torch, narrow, S, C, B, dtype, gids, seed, dev):
    """(dd, first_d, n) through the port's encoder on the card; every 16th
    row from row 8 is an excluded cohort-pool row (gid 1 << 30, written
    into ``gids``) holding garbage dd and non-finite first_d."""
    val, n = hist_block_dev(torch, S, C, B, dtype == "i16", seed, dev)
    dd16, first_d, ok16, ok8, _mono, _exact = narrow.build_narrow_hist(val, n)
    ok = ok8 if dtype == "i8" else ok16
    assert bool(ok[n > 0].all()), "encoder refused integer rows"
    dd = dd16.to(torch.int8) if dtype == "i8" else dd16
    pool = torch.arange(8, S, 16, device=dev)
    gids[pool] = EXCLUDED_GID
    lim = 127 if dtype == "i8" else 32767
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dd[pool] = torch.randint(-lim, lim, (len(pool), C, B), generator=g,
                             device=dev).to(dd.dtype)
    first_d[pool[0]] = float("nan")
    if len(pool) > 1:
        first_d[pool[1]] = float("inf")
    return dd.contiguous(), first_d.contiguous(), n


def k2_vs_plain(fr, fn, dd, first_d, n, gids, ops, G, exact: bool, what,
                window_ms=WINDOW_MS):
    """K2 against its plain twin on the same card tensors: counts bit for
    bit; sums bit for bit when ``exact`` (one row per group: no fold
    rounds), else within rtol 1e-5 of the largest magnitude. Returns the
    max |diff|."""
    import numpy as np
    got = [t.cpu().numpy() for t in fr.fused_hist_kernel(
        fn, window_ms, INTERVAL_MS, dd, first_d, n, gids, ops, G)]
    ref = [t.cpu().numpy() for t in fr.fused_hist_map_plain(
        fn, window_ms, INTERVAL_MS, dd, first_d, n, gids, ops.band, ops.plo,
        ops.lo, ops.hi, ops.rel, G)]
    assert np.isfinite(got[0]).all() and np.isfinite(ref[0]).all(), what
    assert np.array_equal(got[1], ref[1]), (what, "counts differ")
    if exact:
        bad = got[0] != ref[0]
        assert not bad.any(), (what, "not bit-exact", int(bad.sum()),
                               float(np.abs(got[0] - ref[0]).max()))
    else:
        scale = float(np.abs(ref[0]).max(initial=0.0))
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=what)
    return float(np.abs(got[0] - ref[0]).max(initial=0.0))


def phase_hist_kernels(torch, np, fr, narrow, dev):
    """K2 against its plain twin over fn x i8/i16 x S x B x G, sub-range
    and before-the-data steps, excluded rows; then bit-exact with one row
    per group; then the gate refusal."""
    C = 128
    worst, checks = 0.0, 0
    steps = {"full": np.arange(-50_000, (C - 1) * INTERVAL_MS + 1, 30_000,
                               dtype=np.int64),
             "sub": np.arange(60 * INTERVAL_MS, 100 * INTERVAL_MS + 1, 20_000,
                              dtype=np.int64)}
    i = 0
    for S in (512, 4096, 65536):
        for B in (8, 11, 32):
            for G in (8, 64):
                dtype = ("i8", "i16")[i % 2]
                kind = ("full", "sub")[(i // 2) % 2]
                gids = torch.randint(0, G, (S,), device=dev, dtype=torch.int32,
                                     generator=torch.Generator(device=dev)
                                     .manual_seed(i))
                dd, first_d, n = hist_operands_dev(torch, narrow, S, C, B,
                                                   dtype, gids, 200 + i, dev)
                out_ts = steps[kind]
                Tp = -(-len(out_ts) // 128) * 128
                ops = fr.hist_device_operands(C, Tp, out_ts.tobytes(),
                                              WINDOW_MS, 0, INTERVAL_MS, dev)
                for fn in HIST_FNS:
                    worst = max(worst, k2_vs_plain(
                        fr, fn, dd, first_d, n, gids, ops, G, False,
                        f"S={S} B={B} G={G} {dtype} {kind} {fn}"))
                    checks += 1
                i += 1
    # one row per group: every sum is a single contribution, so the window
    # deltas, first samples and extrapolation must agree bit for bit
    exact = 0
    for dtype in ("i8", "i16"):
        for B in (8, 32):
            gids = torch.arange(64, device=dev, dtype=torch.int32)
            dd, first_d, n = hist_operands_dev(torch, narrow, 64, C, B, dtype,
                                               gids, 300 + B, dev)
            for kind, out_ts in steps.items():
                Tp = -(-len(out_ts) // 128) * 128
                ops = fr.hist_device_operands(C, Tp, out_ts.tobytes(),
                                              WINDOW_MS, 0, INTERVAL_MS, dev)
                for fn in HIST_FNS:
                    k2_vs_plain(fr, fn, dd, first_d, n, gids, ops, 64, True,
                                f"exact {dtype} B={B} {kind} {fn}")
                    exact += 1
    # a shape outside the gate never runs anything
    ops = fr.hist_device_operands(C, 128, steps["full"].tobytes(), WINDOW_MS,
                                  0, INTERVAL_MS, dev)
    wide = torch.zeros((512, C, 64), dtype=torch.int8, device=dev)
    zeros = torch.zeros(512, dtype=torch.int32, device=dev)
    before = fr.fused_hist_kernel.launches
    try:
        fr.fused_hist_kernel("rate", WINDOW_MS, INTERVAL_MS, wide,
                             torch.zeros((512, 64), device=dev), zeros, zeros,
                             ops, 8)
        raise AssertionError("K2 accepted Tp * B = 8192")
    except ValueError:
        pass
    assert fr.fused_hist_kernel.launches == before
    torch.cuda.synchronize()
    return checks, exact, worst


def k2_shape_cases(np):
    """(what, S, C, B, dtype, G, out_ts, window_ms) of the shapes K2's
    launch design makes risky: row strides that are not a multiple of 16
    (the covering span; one element a cell where B * elt % 4 != 0, 4-byte
    words at 4-byte but not 16-byte aligned rows), C = 1024 with every
    cell needed (1024 steps of B = 4: four step tiles, the accumulator in
    scratch), G = 64 at Tp * B = 4096 (the accumulator in scratch), S =
    504, and a query with no active step (t1 = t0: only the fold runs)."""
    iv = INTERVAL_MS

    def full(C, step=30_000):
        return np.arange(-50_000, (C - 1) * iv + 1, step, dtype=np.int64)
    return [
        ("stride 1397 B", 4096, 127, 11, "i8", 8, full(127), WINDOW_MS),
        ("stride 1806 B", 4096, 129, 7, "i16", 8, full(129), WINDOW_MS),
        ("stride 1548 B", 4096, 129, 12, "i8", 64, full(129), WINDOW_MS),
        ("C=1024, K=1024", 4096, 1024, 4, "i16", 8,
         np.arange(0, 1024 * iv, iv, dtype=np.int64), WINDOW_MS),
        ("G=64, Tp*B=4096", 65536, 320, 32, "i8", 64,
         np.arange(0, 128 * 20_000, 20_000, dtype=np.int64), WINDOW_MS),
        ("S=504", 504, 320, 32, "i8", 8, full(320, 60_000), WINDOW_MS),
        ("no active step", 4096, 128, 32, "i8", 8,
         np.arange(-400_000, -50_000, 30_000, dtype=np.int64), 30_000),
    ]


def phase_k2_shapes(torch, np, fr, narrow, dev):
    """K2 against its plain twin on k2_shape_cases, x fn; then a chunk
    whose rows are all excluded; then bit for bit with one row per group at
    the two unaligned strides. Returns (checks, exact, max |diff|)."""
    worst, checks, exact = 0.0, 0, 0
    for i, (what, S, C, B, dtype, G, out_ts, window) in enumerate(
            k2_shape_cases(np)):
        gids = torch.randint(0, G, (S,), device=dev, dtype=torch.int32,
                             generator=torch.Generator(device=dev)
                             .manual_seed(400 + i))
        dd, first_d, n = hist_operands_dev(torch, narrow, S, C, B, dtype,
                                           gids, 400 + i, dev)
        if what == "no active step":
            # the first chunks' rows all excluded, too
            gids[:2048] = EXCLUDED_GID
        Tp = -(-len(out_ts) // 128) * 128
        ops = fr.hist_device_operands(C, Tp, out_ts.tobytes(), window, 0,
                                      INTERVAL_MS, dev)
        for fn in HIST_FNS:
            worst = max(worst, k2_vs_plain(
                fr, fn, dd, first_d, n, gids, ops, G, False,
                f"{what} {fn}", window_ms=window))
            checks += 1
        if what == "stride 1397 B":
            # a chunk whose rows are all excluded, beside live chunks
            shape = fr.k2_launch_shape(S, B, 1, G, ops.cmax,
                                       ops.kseg.numel(), ops.nsegs,
                                       ops.nsteps)
            assert shape.nchunks > 2, shape
            gx = gids.clone()
            gx[shape.rows_per_block:2 * shape.rows_per_block] = EXCLUDED_GID
            worst = max(worst, k2_vs_plain(
                fr, "rate", dd, first_d, n, gx, ops, G, False,
                f"{what} excluded chunk"))
            checks += 1
    for C, B, dtype in ((127, 11, "i8"), (129, 7, "i16"), (129, 12, "i8")):
        gids = torch.arange(64, device=dev, dtype=torch.int32)
        dd, first_d, n = hist_operands_dev(torch, narrow, 64, C, B, dtype,
                                           gids, 500 + C, dev)
        out_ts = np.arange(-50_000, (C - 1) * INTERVAL_MS + 1, 30_000,
                           dtype=np.int64)
        ops = fr.hist_device_operands(C, 128, out_ts.tobytes(), WINDOW_MS, 0,
                                      INTERVAL_MS, dev)
        for fn in HIST_FNS:
            k2_vs_plain(fr, fn, dd, first_d, n, gids, ops, 64, True,
                        f"exact C={C} B={B} {dtype} {fn}")
            exact += 1
    torch.cuda.synchronize()
    return checks, exact, worst


def ingest_hist_small(RecordBuilder, PROM_HISTOGRAM, shards, np, n_series,
                      B):
    """``n_series`` histograms x 100 samples through the real ingest path:
    integer cumulative counts, one series in 16 scaled by 0.3 (non-integer:
    the cohort pool), one in 16 with a counter reset (the pool too)."""
    rng = np.random.default_rng(5)
    les = np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])
    n_samples, per = 100, 256
    ts = BASE_TS + np.arange(n_samples, dtype=np.int64) * INTERVAL_MS
    for c0 in range(0, n_series, per):
        b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
        for s in range(c0, c0 + per):
            c = np.cumsum(np.cumsum(rng.poisson(0.3, (n_samples, B)), axis=0),
                          axis=1).astype(np.float64)
            if s % 16 == 7:
                c = c * 0.3
            elif s % 16 == 11:
                c[60:] -= c[60]
            b.add_batch({"_metric_": "h", "host": f"h{s % 8}",
                         "inst": f"i{s}"}, ts, c)
        cont = b.build()
        for sh in shards:
            sh.ingest(cont)
    for sh in shards:
        sh.flush()


HIST_SMALL_QUERIES = (
    "histogram_quantile(0.9, sum(rate(h[5m])))",
    "histogram_quantile(0.5, sum by (host) (increase(h[5m])))",
    "histogram_quantile(0.99, sum(delta(h[5m])))",
    "histogram_quantile(0.9, sum(sum_over_time(h[5m])))",
    'histogram_quantile(0.9, sum(rate(h{host="h3"}[5m])))')


def phase_hist_small(torch, np, fr, pkg, devs=("cuda", "cpu")):
    """Histogram engine, card against CPU, through real ingest and flush in
    both residencies; K2 must launch once per K2-route query."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, PROM_HISTOGRAM, \
        QueryEngine = pkg
    launched = {}
    for mode in ("off", "all"):
        engines, shards = {}, []
        for dev in devs:
            ms = TimeSeriesMemStore(device=dev)
            shards.append(ms.setup("p", PROM_HISTOGRAM, 0, StoreConfig(
                max_series_per_shard=1024, samples_per_series=128,
                flush_batch_size=10**9, compressed_residency=mode,
                device=dev)))
            engines[dev] = QueryEngine(ms, "p", device=dev)
        ingest_hist_small(RecordBuilder, PROM_HISTOGRAM, shards, np, 1024, 16)
        for sh in shards:
            assert sh.store.is_narrow_resident == (mode == "all"), mode
        if mode == "all":
            _dd, _fd, ok = shards[0].store.hist_operands()
            assert int((~ok[:1024]).sum()) == 128, int((~ok[:1024]).sum())
        start, end, step = BASE_TS + 300_000, BASE_TS + 990_000, 30_000
        fr.fused_hist_kernel.launches = 0
        got = {q: engines[devs[0]].query_range(q, start, end, step)
               for q in HIST_SMALL_QUERIES}
        launched[mode] = fr.fused_hist_kernel.launches
        for q in HIST_SMALL_QUERIES:
            g, r = got[q], engines[devs[1]].query_range(q, start, end, step)
            assert [k.labels for k in g.matrix.keys] == \
                [k.labels for k in r.matrix.keys], q
            gv = np.asarray(g.matrix.values, np.float64)
            rv = np.asarray(r.matrix.values, np.float64)
            assert gv.shape == rv.shape and gv.shape[1] == len(r.matrix.out_ts)
            assert np.isfinite(rv).any(), q
            # quantiles within 1e-3: the partials agree to 1e-5 and the
            # interpolation divides by one bucket's count difference
            np.testing.assert_allclose(gv, rv, rtol=1e-3, atol=1e-6,
                                       equal_nan=True, err_msg=f"{mode} {q}")
            assert g.stats.fused_kernels == r.stats.fused_kernels, q
            assert g.exec_path.split("[")[0] == r.exec_path.split("[")[0], \
                (q, g.exec_path, r.exec_path)
        fused = sum(got[q].stats.fused_kernels for q in HIST_SMALL_QUERIES)
        assert launched[mode] == fused == (3 if mode == "all" else 0), \
            (mode, launched[mode], fused)
    return launched["all"]


def build_hist_scale(torch, np, pkg, dev):
    """2^17 histogram series registered through the real ingest path, then
    their 300 samples x 32 buckets installed on the card from a seeded
    torch.Generator (integer counts; one row in 16 scaled by 0.3), with
    the schema's ``count`` column (the +Inf bucket) and ``sum`` column (each
    bucket's new observations at its midpoint) derived from the same
    counts; then the shard's flush compresses the bucket block through
    compress_prepare / compress_commit, as after any ingest (the scalar
    columns stay raw f32). Returns (engine, shard, registration s,
    compression s, raw sample bytes, the HIST_SAMPLE_ROWS rows' cells as
    installed). The engine's sample limit admits a per-series answer over
    every series (phase 9b's H2)."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, PROM_HISTOGRAM, \
        QueryEngine = pkg
    from filodb_tpu_torch.query.engine import QueryConfig
    S, B = HIST_SERIES, HIST_BUCKETS
    les = np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])
    mids = torch.tensor(np.concatenate([[0.5], 0.75 * les[1:-1],
                                        [1.5 * les[-2]]]),
                        dtype=torch.float32, device=dev)
    ms = TimeSeriesMemStore(device=dev)
    shard = ms.setup("bench", PROM_HISTOGRAM, 0, StoreConfig(
        max_series_per_shard=S, samples_per_series=HIST_CAPACITY,
        flush_batch_size=10**9, compressed_residency="all", device=dev))
    t0 = time.perf_counter()
    b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
    b.add_series_batch({"_metric_": "req_latency",
                        "host": [f"h{i}" for i in range(S)]},
                       BASE_TS, np.zeros(B))
    shard.ingest(b.build())
    shard.discard_staged()      # registration only: data installed below
    reg_s = time.perf_counter() - t0
    assert shard.num_series == S
    st = shard.store
    g = torch.Generator(device=dev).manual_seed(17)
    rate = torch.full((HIST_BATCH, HIST_SAMPLES, B), 0.3, device=dev)
    with shard.lock:
        for r0 in range(0, S, HIST_BATCH):
            c = torch.cumsum(torch.cumsum(torch.poisson(rate, generator=g), 1),
                             2)
            rows = torch.arange(r0, r0 + HIST_BATCH, device=dev)
            c = torch.where((rows % 16 == 15)[:, None, None], c * 0.3, c)
            st.val[r0:r0 + HIST_BATCH, :HIST_SAMPLES] = c
            st.extra["count"][r0:r0 + HIST_BATCH, :HIST_SAMPLES] = c[..., -1]
            st.extra["sum"][r0:r0 + HIST_BATCH, :HIST_SAMPLES] = (
                torch.diff(c, dim=2, prepend=torch.zeros_like(c[..., :1]))
                @ mids)
        row = BASE_TS + torch.arange(HIST_SAMPLES, device=dev) * INTERVAL_MS
        st.ts[:, :HIST_SAMPLES] = row
        st.n.fill_(HIST_SAMPLES)
        st.n_host[:] = HIST_SAMPLES
        st.first_ts[:] = BASE_TS
        st.last_ts[:] = BASE_TS + (HIST_SAMPLES - 1) * INTERVAL_MS
        st.grid_base, st.grid_interval, st.grid_ok = BASE_TS, INTERVAL_MS, True
        st.stats.samples_appended += S * HIST_SAMPLES
        sampled = st.val[torch.tensor(HIST_SAMPLE_ROWS, device=dev),
                         :HIST_SAMPLES].cpu().numpy()
    raw_bytes = st.resident_sample_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shard.flush()
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    assert st.is_narrow_resident and st.val is None and st.ts is None
    dd, _first_d, ok = st.hist_operands()
    assert dd.dtype == torch.int8, dd.dtype
    assert int((~ok).sum()) == S // 16, int((~ok).sum())
    engine = QueryEngine(ms, "bench", device=dev,
                         config=QueryConfig(sample_limit=S * 64))
    return engine, shard, reg_s, comp_s, raw_bytes, sampled


HIST_START = BASE_TS + 600_000
HIST_END = BASE_TS + (HIST_SAMPLES - 10) * INTERVAL_MS


def hist_scale_queries(torch, fr, engine):
    """Phase 7's query through the engine: two to load and warm, then 11
    timed by the host clock with K2's count set to 0 just before and read
    just after (one launch each). Returns (p50 ms, last result, the 11
    latencies, launches)."""
    import numpy as np
    for _ in range(2):                                 # load + warm
        engine.query_range(HIST_QUERY, HIST_START, HIST_END, HIST_STEP_MS)
    torch.cuda.synchronize()
    # the main path: counts from 0, read right after
    fr.fused_hist_kernel.launches = 0
    lat, r = [], None
    for _ in range(11):
        t0 = time.perf_counter()
        r = engine.query_range(HIST_QUERY, HIST_START, HIST_END,
                               HIST_STEP_MS)
        lat.append((time.perf_counter() - t0) * 1000)
    launches = fr.fused_hist_kernel.launches
    assert launches == 11, launches
    return float(np.percentile(lat, 50)), r, lat, launches


def hist_scale_operands(torch, np, fr, engine, shard):
    """K2's operands at phase 7's query, from the engine's own selection:
    (data, dd, first_d, n, gids, gids on the card, pool correction, ops,
    padded steps, true step count)."""
    from filodb_tpu_torch.core.filters import Equals
    from filodb_tpu_torch.query import engine as qe
    from filodb_tpu_torch.query.exec import SelectRawPartitionsExec, _pad_steps
    out_ts = np.arange(HIST_START, HIST_END + 1, HIST_STEP_MS, dtype=np.int64)
    leaf = SelectRawPartitionsExec(
        shard=0, filters=(Equals("_metric_", "req_latency"),),
        start_ms=HIST_START - WINDOW_MS, end_ms=HIST_END)
    ctx = engine._ctx()
    with shard.lock:
        data = leaf.do_execute(ctx)
    dd, first_d, bad = data.hist_narrow
    S, C, _B = dd.shape
    out_eval, T = _pad_steps(out_ts)
    gids, corr = qe.pool_correction(data, np.zeros(S, np.int32), bad, 8,
                                    "rate", out_eval, WINDOW_MS)
    gids_t = torch.from_numpy(gids).to(dd.device)
    Tp = -(-len(out_eval) // 128) * 128
    ops = fr.hist_device_operands(C, Tp, out_eval.tobytes(), WINDOW_MS,
                                  BASE_TS, INTERVAL_MS, dd.device)
    return (data, dd, first_d, data.n.contiguous(), gids, gids_t, corr, ops,
            out_eval, T)


def phase_hist_scale(torch, np, fr, card, pkg, dev="cuda"):
    engine, shard, reg_s, comp_s, raw_bytes, sampled = build_hist_scale(
        torch, np, pkg, dev)
    st = shard.store
    res_bytes = st.resident_sample_bytes()
    log(f"hist scale: registered {HIST_SERIES} series in {reg_s:.1f} s; "
        f"compressed at flush in {comp_s:.2f} s; resident sample bytes "
        f"{raw_bytes / 1e9:.3f} GB raw -> {res_bytes / 1e9:.3f} GB "
        f"({raw_bytes / res_bytes:.2f}x), dd int8 + {HIST_SERIES // 16} "
        "pool rows")
    start, end = HIST_START, HIST_END
    p50, r, lat, launches = hist_scale_queries(torch, fr, engine)
    assert r.exec_path == ("fused-hist-narrow[cuda]" if dev == "cuda"
                           else "fused-hist-narrow[plain]"), r.exec_path
    vals = np.asarray(r.matrix.values)
    out_ts = np.arange(start, end + 1, HIST_STEP_MS, dtype=np.int64)
    assert vals.shape == (1, len(out_ts)) and np.isfinite(vals).all(), \
        vals.shape

    # the same selection as the engine's, then K2 against its plain twin
    # and the engine's quantiles against the twin's
    data, dd, first_d, n, gids, gids_t, corr, ops, out_eval, T = \
        hist_scale_operands(torch, np, fr, engine, shard)
    S, C, B = dd.shape
    Tp = ops.lo.numel()
    worst = k2_vs_plain(fr, "rate", dd, first_d, n, gids_t, ops, 8, False,
                        "hist scale")
    ps, pc = fr.fused_hist_map_plain("rate", WINDOW_MS, INTERVAL_MS, dd,
                                     first_d, n, gids_t, ops.band, ops.plo,
                                     ops.lo, ops.hi, ops.rel, 8)
    want = fr.hist_finish(0.9, data.bucket_les, ps, pc, len(out_eval), B,
                          corr)[:1, :T].cpu().numpy()
    # quantiles within 1e-3: the partials agree to 1e-5 (K2 vs twin above)
    # and the interpolation divides by one bucket's count difference
    np.testing.assert_allclose(vals, want, rtol=1e-3, err_msg="hist quantile")

    k_ms = cuda_ms(lambda: fr.fused_hist_kernel(
        "rate", WINDOW_MS, INTERVAL_MS, dd, first_d, n, gids_t, ops, 8),
        reps=20)
    shape = fr.k2_launch_shape(S, B, dd.element_size(), 8, ops.cmax,
                               ops.kseg.numel(), ops.nsegs, ops.nsteps)
    fold_ms = k2_fold_ms(torch, fr, shape, B, Tp, 8, ops, dd.device)
    p_ms = cuda_ms(lambda: fr.fused_hist_map_plain(
        "rate", WINDOW_MS, INTERVAL_MS, dd, first_d, n, gids_t, ops.band,
        ops.plo, ops.lo, ops.hi, ops.rel, 8), reps=3, warm=1)
    # what this run's data needs: the rows K2 reads (in a group, >= 2
    # samples) up to the last cell any step needs, their first_d, every
    # row's n and gid, the [2, G, Tp*B] output; ~40 f32 operations per
    # (row, step, bucket) of a window with >= 2 samples, B adds per cell
    key, bw, f32 = peaks_for(card)
    live = int(((gids < 8) & (data.n.cpu().numpy() >= 2)).sum())
    cmax = ops.cmax
    # the distinct steps (the engine's padding repeats the last one)
    us = ops.usteps.cpu().numpy()
    lo_h, hi_h = ops.lo.cpu().numpy()[0][us], ops.hi.cpu().numpy()[0][us]
    steps2 = int(((np.minimum(hi_h, HIST_SAMPLES - 1)
                   - np.maximum(lo_h, 0) + 1) >= 2).sum())
    nbytes = (live * ((cmax + 1) * B * dd.element_size() + B * 4)
              + S * 8 + 2 * 8 * Tp * B * 4)
    flops = live * float(steps2 * B * 40 + (cmax + 1) * B)
    bound_ms = max(nbytes / bw, flops / f32) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / f32 else "operations"
    log(f"hist scale [{card}]: engine single-query p50 {p50:.3f} ms "
        f"({HIST_QUERY}, {T} steps, 11 queries, {launches} K2 launches); "
        f"last query's stages (host clock, ms) "
        f"{ {k: round(v, 3) for k, v in r.stats.stage_ms.items()} }")
    log(f"hist scale [{card}]: K2 {k_ms:.4f} ms by CUDA events (fold "
        f"{fold_ms:.4f} ms of it); plain twin {p_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB at {key}'s "
        f"{bw / 1e12:.2f} TB/s, {flops / 1e9:.2f} GFLOP at "
        f"{f32 / 1e12:.0f} TFLOP/s f32)")
    # the launch: one block an SM (its shared memory), a pass of rows in
    # flight while the block works on the one before
    span = (cmax + 1) * B * dd.element_size()
    log(f"hist scale [{card}]: K2 launch shape {shape.nchunks} blocks of "
        f"{fr.K2_THREADS} threads x {shape.rows_per_block} rows, "
        f"{shape.rows_pass} rows a pass, 2 stages, {shape.smem} B shared "
        f"memory (accumulator {'shared' if shape.acc_shared else 'in scratch'}"
        f"), {shape.rows_pass * span} dd bytes in flight per SM while a pass "
        f"works; {ops.kseg.numel()} needed cells in {ops.nsegs} segments, "
        f"{ops.nsteps} distinct of {int((ops.ucol >= 0).sum())} active steps")
    log(f"hist scale [{card}]: library call: none (no single PyTorch call "
        f"computes this function); launches per query {launches / 11:.2f}; "
        f"K2 vs plain max |diff| {worst:.3g}")
    return (dict(launches=launches, max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                 bound_ms=bound_ms, bound_by=bound_by), engine, shard, sampled)


def k2_fold_ms(torch, fr, shape, B, Tp, G, ops, dev):
    """Device ms of K2's second pass alone, on a scratch of the shape K2's
    launch at these operands uses."""
    scratch = torch.zeros((shape.nchunks, 2, G, ops.nsteps * B), device=dev)
    out = torch.empty((2, G, Tp * B), device=dev)
    lib = fr._k2_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fold():
        assert lib.fusedhist_fold(scratch.data_ptr(), out.data_ptr(),
                                  shape.nchunks, 2 * G, B, Tp, ops.nsteps,
                                  ops.ucol.data_ptr(), stream) == 0
    return cuda_ms(fold, reps=50)


def profile_hist(torch, np, fr, fg, card, pkg, named=(),
                 queries: int = 5) -> None:
    """Where scale-phase histogram queries spend their time (phase 7's
    query unless ``named`` lists others, each over phase 7's range): host
    clock and CUDA events per query, torch.profiler's device kernels by
    total time (and the device's busy share of the host p50), cProfile's
    host functions by cumulative time. Writes the tables to chiprun_out/."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile
    engine, _shard, _reg, _comp, _raw, _cells = build_hist_scale(
        torch, np, pkg, "cuda")
    report = [f"card: {card}"]
    for q in named or (HIST_QUERY,):
        def run():
            engine.query_range(q, HIST_START, HIST_END, HIST_STEP_MS)

        log(f"query: {q}")
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        host, dev = [], []
        for _ in range(queries):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(a.elapsed_time(b))
        p50 = float(np.percentile(host, 50))
        timed = (f"[{card}] hist query host ms p50 {p50:.3f}; events around "
                 f"the query p50 {np.percentile(dev, 50):.3f} ms")
        log(timed)
        fr.fused_hist_kernel.launches = 0
        reset_k1(fg)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(queries):
                run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # device rows only: an aten op's row repeats its kernels' time
        dev_ms = sum(e.self_device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation) / 1e3 / queries
        table = events.table(sort_by="self_device_time_total", row_limit=20)
        log(table)
        busy = (f"[{card}] device time per query {dev_ms:.3f} ms over "
                f"{queries} profiled queries, busy share of the host p50 "
                f"{dev_ms / p50:.3f}; K2 launches "
                f"{fr.fused_hist_kernel.launches}, K1 launches "
                f"{fg.fused_grid_kernel.launches}")
        log(busy)
        pr = cProfile.Profile()
        pr.enable()
        for _ in range(queries):
            run()
        pr.disable()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(30)
        log(buf.getvalue())
        report += [f"query: {q}", timed, busy, table, buf.getvalue()]
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_hist_query.txt"), "w") as f:
        f.write("\n".join(report) + "\n")


def k2_parts(torch, np, fr, card, pkg, out_path: str, dev="cuda") -> None:
    """Phase 7's store and query with the package at ROOT: the engine's
    single-query p50, K2's time by CUDA events (with the scratch zeroing
    and the fold, as a caller pays them), and K2's partials saved to
    ``out_path``."""
    engine, shard, _reg, _comp, _raw, _cells = build_hist_scale(torch, np,
                                                                pkg, dev)
    p50, _r, lat, _launches = hist_scale_queries(torch, fr, engine)
    _data, dd, first_d, n, _g, gids_t, _corr, ops, _oe, _T = \
        hist_scale_operands(torch, np, fr, engine, shard)

    def k2():
        return fr.fused_hist_kernel("rate", WINDOW_MS, INTERVAL_MS, dd,
                                    first_d, n, gids_t, ops, 8)
    psum, pcnt = k2()
    k_ms = cuda_ms(k2, reps=20)
    torch.save({"sum": psum.cpu(), "count": pcnt.cpu()}, out_path)
    log(f"k2 parts [{card}] {ROOT}: K2 {k_ms:.4f} ms by CUDA events; engine "
        f"single-query p50 {p50:.3f} ms (min {min(lat):.3f}); partials "
        f"saved to {out_path}")


def k2_compare(torch, paths) -> bool:
    """Whether every saved K2 partial equals the first's bit for bit."""
    ref = torch.load(paths[0])
    same = True
    for p in paths[1:]:
        got = torch.load(p)
        for k in ("sum", "count"):
            eq = bool(torch.equal(got[k].view(torch.int32),
                                  ref[k].view(torch.int32)))
            log(f"k2 compare: {p} {k} bit for bit as {paths[0]}: {eq}")
            same = same and eq
    return same


# ---- phase 8: the general PromQL path --------------------------------------

# phase 8a's mix: every range function and the instant selector, scalar and
# vector operators, set operators, instant, sort, label and scalar
# functions, classic le histogram quantiles, the order statistics
GENERAL_QUERIES = (
    "rate(m[5m])", "increase(m[5m])", "delta(m[5m])", "irate(m[5m])",
    "idelta(m[5m])", "sum_over_time(m[5m])", "count_over_time(m[5m])",
    "avg_over_time(m[5m])", "min_over_time(m[5m])", "max_over_time(m[5m])",
    "stddev_over_time(m[5m])", "stdvar_over_time(m[5m])",
    "last_over_time(m[5m])", "changes(g[5m])", "resets(m[5m])",
    "deriv(m[5m])", "predict_linear(m[5m], 600)",
    "quantile_over_time(0.9, m[5m])", "holt_winters(m[5m], 0.5, 0.1)",
    "m", "g",
    "rate(m[5m]) * 2", "2 / rate(m[5m])", "rate(m[5m]) % 0.3",
    "rate(m[5m]) ^ 2", "-rate(m[5m])", "rate(m[5m]) > 0.5",
    "rate(m[5m]) > bool 0.5", "g == 3", "g != bool 3",
    "rate(m[5m]) * scalar(sum(g))", "time() - timestamp(m)",
    "rate(m[5m]) / irate(m[5m])",
    'sum(rate(m{host=~"h1.*"}[5m])) / sum(rate(m[5m]))',
    "rate(m[5m]) / on(host) group_left sum by (host) (rate(m[5m]))",
    "sum by (host) (g) * on(host) group_right rate(m[5m])",
    "rate(m[5m]) and on(inst) (g > 3)", "m or g",
    "rate(m[5m]) unless on(inst) (g > 2)",
    "abs(delta(m[5m]))", "clamp_min(rate(m[5m]), 0.4)",
    "round(rate(m[5m]), 0.1)", "hour(timestamp(m))", "absent(nope)",
    "histogram_quantile(0.9, sum by (le) (rate(lat_bucket[5m])))",
    "histogram_quantile(0.5, sum by (le, host) (rate(lat_bucket[5m])))",
    'label_replace(rate(m[5m]), "hostnum", "$1", "host", "h(.*)")',
    "sort_desc(rate(m[5m]))", "scalar(sum(g))", "vector(1)", "time()",
    "topk(3, rate(m[5m]))", "topk(2, g)", "bottomk(3, g)",
    "topk by (host) (2, rate(m[5m]))", "bottomk by (host) (1, g)",
    "quantile(0.9, rate(m[5m]))", "quantile by (host) (0.5, g)",
    'count_values("v", g)', 'count_values by (host) ("v", g)',
    "count(rate(m[5m]) > 0.5)",
)
# answers that are counts or small integers: the card equals the CPU
GENERAL_EXACT = {
    "count_over_time(m[5m])", "changes(g[5m])", "resets(m[5m])", "g",
    "g == 3", "g != bool 3", "topk(2, g)", "bottomk(3, g)",
    "bottomk by (host) (1, g)", 'count_values("v", g)',
    'count_values by (host) ("v", g)', "quantile by (host) (0.5, g)",
    "scalar(sum(g))", "vector(1)", "time()", "absent(nope)"}
GENERAL_INSTANT = ("m", "topk(2, g)", 'count_values("v", g)', "sum(m)")
GENERAL_LES = ("0.1", "0.5", "1", "+Inf")


def ingest_general(RecordBuilder, GAUGE, shards, np):
    """Phase 8a's store through the real ingest path, 100 samples a series:
    1024 counters ``m`` with resets (a sixteenth start 20 cells late: a
    churned cohort), 256 small-integer gauges ``g`` (ties, repeated
    values), classic histogram counters ``lat_bucket`` (8 hosts x 4 le)."""
    rng = np.random.default_rng(6)
    n_samples = 100

    def ts_of(s):
        late = 20 if s % 16 == 5 else 0
        return BASE_TS + (late + np.arange(n_samples - late,
                                           dtype=np.int64)) * INTERVAL_MS
    b = RecordBuilder(GAUGE)
    for s in range(1024):
        ts = ts_of(s)
        vals = np.cumsum(rng.exponential(5.0, len(ts)))
        if s % 7 == 3:
            vals[len(ts) // 2:] -= vals[len(ts) // 2] - 1.0   # counter reset
        b.add_batch({"_metric_": "m", "host": f"h{s % 8}", "inst": f"i{s}"},
                    ts, vals)
    for s in range(256):
        ts = ts_of(s)
        b.add_batch({"_metric_": "g", "host": f"h{s % 8}", "inst": f"i{s}"},
                    ts, rng.integers(0, 6, len(ts)).astype(np.float64))
    for h in range(8):
        ts = ts_of(h)
        cum = np.cumsum(np.cumsum(rng.poisson(2.0, (len(ts), 4)), axis=1),
                        axis=0).astype(np.float64)
        for j, le in enumerate(GENERAL_LES):
            b.add_batch({"_metric_": "lat_bucket", "host": f"h{h}", "le": le},
                        ts, cum[:, j])
    cont = b.build()
    for sh in shards:
        sh.ingest(cont)
        sh.flush()


def phase_general_small(torch, np, fg, pkg, devs=("cuda", "cpu")):
    """Phase 8a: the general mix on the card against the CPU engine.
    Returns (queries, K1 launches, fused routes)."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    engines, shards = {}, []
    for dev in devs:
        ms = TimeSeriesMemStore(device=dev)
        shards.append(ms.setup("p", GAUGE, 0, StoreConfig(
            max_series_per_shard=2048, samples_per_series=128,
            flush_batch_size=10**9, device=dev)))
        engines[dev] = QueryEngine(ms, "p", device=dev)
    ingest_general(RecordBuilder, GAUGE, shards, np)
    kind, _ = shards[0].store.grid_cohorts()
    assert kind == "mixed", kind
    start, end, step = BASE_TS + 300_000, BASE_TS + 990_000, 30_000
    t_inst = BASE_TS + 700_000
    card, cpu = engines[devs[0]], engines[devs[1]]
    # the main path: counts from 0, read right after
    reset_k1(fg)
    got = {q: card.query_range(q, start, end, step) for q in GENERAL_QUERIES}
    got_i = {q: card.query_instant(q, t_inst) for q in GENERAL_INSTANT}
    launches = fg.fused_grid_kernel.launches
    fused = (sum(r.stats.fused_kernels for r in got.values())
             + sum(r.stats.fused_kernels for r in got_i.values()))
    assert launches == fused >= 5, (launches, fused)
    for q in GENERAL_QUERIES:
        compare_result(np, q, got[q], cpu.query_range(q, start, end, step),
                       q in GENERAL_EXACT)
    for q in GENERAL_INSTANT:
        r = cpu.query_instant(q, t_inst)
        assert got_i[q].result_type == r.result_type == "vector", q
        compare_result(np, q, got_i[q], r, q != "sum(m)")
    ratio = got['sum(rate(m{host=~"h1.*"}[5m])) / sum(rate(m[5m]))']
    assert ratio.stats.fused_kernels == 2, ratio.stats.fused_kernels
    return len(GENERAL_QUERIES) + len(GENERAL_INSTANT), launches, fused


# phase 8b's queries over phase 4's store (bench range variant 0)
SCALE_GENERAL = {
    "S1": 'sum(rate(m{host=~"h1.*"}[5m])) / sum(rate(m[5m]))',
    "S2": "topk(10, rate(m[5m]))",
    "S3": "quantile(0.99, rate(m[5m]))",
    "S4": "max(max_over_time(m[5m]))",
    "S5": "count(rate(m[5m]) > 0.5)",
    "S6": "avg(irate(m[5m]))",
    "S7": "sum(m)",
}
SCALE_GENERAL_REPS = 3


def phase_general_scale(torch, np, fg, card, engine, shard):
    """Phase 8b: S1-S7 through the engine on phase 4's store, each held
    against an independent device computation on the same store; returns
    {name: p50 ms} and K1's launches a query."""
    from filodb_tpu_torch.ops import gridfns
    S = shard.num_series
    s, e = range_variants(shard)[0]
    out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
    T = len(out_ts)
    t_last = int(shard.store.last_ts.max())

    def run(name):
        if name == "S7":
            return engine.query_instant(SCALE_GENERAL[name], t_last)
        return engine.query_range(SCALE_GENERAL[name], s, e, STEP_MS)

    for name in SCALE_GENERAL:                 # first calls: load + warm
        run(name)
    # the main path: counts from 0, read right after
    reset_k1(fg)
    res, lat, k1 = {}, {}, {}
    for name in SCALE_GENERAL:
        before = fg.fused_grid_kernel.launches
        times = []
        for _ in range(SCALE_GENERAL_REPS):
            t0 = time.perf_counter()
            res[name] = run(name)
            times.append((time.perf_counter() - t0) * 1000)
        lat[name] = float(np.percentile(times, 50))
        k1[name] = (fg.fused_grid_kernel.launches - before) / SCALE_GENERAL_REPS
        assert k1[name] == res[name].stats.fused_kernels, (name, k1[name])
    assert k1["S1"] == 2 and sum(k1.values()) == 2, k1

    st = shard.store
    # S1 against the quotient of its legs' answers, taken on the host in
    # their own dtype (f32 sums, as the join divides them): within an f32
    # ulp of the card's division
    legs = [np.asarray(engine.query_range(q, s, e, STEP_MS).matrix.values)
            for q in ('sum(rate(m{host=~"h1.*"}[5m]))', "sum(rate(m[5m]))")]
    want = (legs[0] / legs[1]).astype(np.float64)
    v1 = np.asarray(res["S1"].matrix.values, np.float64)
    assert v1.shape == (1, T) and np.isfinite(v1).all(), v1.shape
    np.testing.assert_allclose(v1, want, rtol=float(np.finfo(np.float32).eps),
                               err_msg="S1")
    # the rate matrix of the whole store through the grid function
    out_eval = np.concatenate([out_ts, np.full(-(-T // 32) * 32 - T,
                                               out_ts[-1], np.int64)])
    rate = gridfns.periodic_samples_grid(st.val, st.n, out_eval, WINDOW_MS,
                                         "rate", BASE_TS, INTERVAL_MS)[:, :T]
    assert rate.shape == (S, T) and bool(torch.isfinite(rate).all())
    # S2: a stable top 10 per step, lower row first among equal values
    top = torch.sort(rate.T, dim=1, descending=True, stable=True)
    want2 = {}
    rows, vals = top.indices[:, :10].cpu().numpy(), top.values[:, :10].cpu()
    for t in range(T):
        for j in range(10):
            want2.setdefault(f"h{rows[t, j]}", {})[t] = float(vals[t, j])
    got2 = {}
    v2 = np.asarray(res["S2"].matrix.values, np.float64)
    for key, row in zip(res["S2"].matrix.keys, v2):
        got2[key.as_dict()["host"]] = {t: float(row[t]) for t in range(T)
                                       if not np.isnan(row[t])}
    assert got2 == want2, "S2: not the stable top 10 of the rate matrix"
    # S3: torch.quantile of each step's rates, within the sketch's error
    exact3 = np.array([float(torch.quantile(rate[:, t].double(), 0.99))
                       for t in range(T)])
    v3 = np.asarray(res["S3"].matrix.values, np.float64)[0]
    err3 = float(np.abs(v3 / exact3 - 1).max())
    assert err3 <= 0.0196, ("S3", err3)
    # S4 and S6: a plain windowed max and irate, written out over the
    # store's cells and not through the engine's range functions. Every row
    # is full and cell i sits at BASE_TS + i * INTERVAL_MS, so the window
    # [t - 5m, t] is the cells lo..hi of every row
    cells = int(st.n_host.max())
    assert int(st.n_host.min()) == cells and bool(
        (st.ts[:, :cells] == BASE_TS + INTERVAL_MS * torch.arange(
            cells, device=st.ts.device)).all()), "the store is not on its grid"
    want4, want6 = np.empty(T), np.empty(T)
    for k, t in enumerate(out_ts.tolist()):
        lo = max(-(-(t - WINDOW_MS - BASE_TS) // INTERVAL_MS), 0)
        hi = min((t - BASE_TS) // INTERVAL_MS, cells - 1)
        win = st.val[:, lo:hi + 1]
        want4[k] = float(win.amax())
        prev, last = win[:, -2].double(), win[:, -1].double()
        # a counter reset between the last two samples: the counter restarted
        want6[k] = float((torch.where(last >= prev, last - prev, last)
                          / (INTERVAL_MS / 1000.0)).mean())
    v4 = np.asarray(res["S4"].matrix.values, np.float64)[0]
    assert np.array_equal(v4, want4), ("S4", v4[:4], want4[:4])
    v6 = np.asarray(res["S6"].matrix.values, np.float64)[0]
    np.testing.assert_allclose(v6, want6, rtol=1e-9, err_msg="S6")
    # S5: exactly, as a count
    want5 = (rate > 0.5).sum(0).double().cpu().numpy()
    v5 = np.asarray(res["S5"].matrix.values, np.float64)[0]
    assert np.array_equal(v5, want5), ("S5", v5[:4], want5[:4])
    # S7: the f64 sum of each row's last value (the engine sums the f32
    # grid output in f32, as the reference does: rtol 1e-4 over 2^20 rows)
    last = st.val[torch.arange(st.S, device=st.val.device),
                  (st.n.long() - 1).clamp(min=0)]
    want7 = float(last.double().sum())
    v7 = np.asarray(res["S7"].matrix.values, np.float64)
    assert v7.shape == (1, 1), v7.shape
    assert abs(v7[0, 0] / want7 - 1) <= 1e-4, ("S7", v7[0, 0], want7)
    log(f"general scale [{card}]: {S} series x {T} steps; S1 "
        f"max rel diff to its legs {float(np.abs(v1 / want - 1).max()):.3g}; "
        f"S3 max rel err {err3:.4f}; S5 {v5.min():.0f}-{v5.max():.0f} of "
        f"{S} rates above 0.5; S6 max rel diff "
        f"{float(np.abs(v6 / want6 - 1).max()):.3g}; S7 rel diff "
        f"{abs(v7[0, 0] / want7 - 1):.3g}")
    for name, q in SCALE_GENERAL.items():
        log(f"general scale [{card}]: {name} {q}: p50 {lat[name]:.3f} ms "
            f"over {SCALE_GENERAL_REPS} runs, K1 launches a query "
            f"{k1[name]:g}")
    return lat, int(sum(k1.values()) * SCALE_GENERAL_REPS)


# ---- phase 9: the general histogram path ------------------------------------

# phase 9a's mix: the range functions and the instant selector over
# histograms, per-series quantiles and bucket picks, the bucket-wise
# reduce, quantiles of sums (the fused-hist routes on one aligned shard,
# the general path elsewhere) and the average-latency panel over the
# schema's sum and count columns
HIST_GENERAL_QUERIES = (
    "rate(h[5m])", "increase(h[5m])", "delta(h[5m])", "sum_over_time(h[5m])",
    "last_over_time(h[5m])", "h",
    "histogram_quantile(0.9, rate(h[5m]))",
    "histogram_max_quantile(0.99, increase(h[5m]))",
    "histogram_bucket(64, rate(h[5m]))",
    "sum by (host) (rate(h[5m]))", "sum(rate(h[5m]))",
    "count(increase(h[5m]))",
    "histogram_quantile(0.9, sum(rate(h[5m])))",
    "histogram_quantile(0.5, sum by (host) (rate(h[5m])))",
    'sum(rate(h{__col__="sum"}[5m])) / sum(rate(h{__col__="count"}[5m]))',
)
HIST_GENERAL_EXACT = {"h", "last_over_time(h[5m])", "count(increase(h[5m]))"}
HIST_GENERAL_INSTANT = ("h", "histogram_quantile(0.9, rate(h[5m]))")
# (residency, layout) of phase 9a's datasets
HIST_GENERAL_SETS = (("off", "aligned"), ("all", "aligned"),
                     ("all", "churned"), ("off", "offgrid"),
                     ("all", "two_shard"))


def ingest_hist_general(RecordBuilder, PROM_HISTOGRAM, stores, np, layout):
    """Phase 6's 1024 histograms (B = 16, 100 samples; one series in 16
    scaled by 0.3 and one with a counter reset: the cohort pool) with the
    schema's sum and count columns, through the real ingest path into
    every memstore of ``stores``. ``churned``: a sixteenth start 20 cells
    late; ``offgrid``: every sample a few ms off its cell; ``two_shard``:
    series alternate between shards 0 and 1."""
    rng = np.random.default_rng(5)
    B, n_samples, per = 16, 100, 256
    les = np.concatenate([2.0 ** np.arange(B - 1), [np.inf]])
    mids = np.concatenate([[0.5], 0.75 * les[1:-1], [1.5 * les[-2]]])
    nsh = 2 if layout == "two_shard" else 1
    for c0 in range(0, 1024, per):
        bs = [RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
              for _ in range(nsh)]
        for s in range(c0, c0 + per):
            c = np.cumsum(np.cumsum(rng.poisson(0.3, (n_samples, B)), axis=0),
                          axis=1).astype(np.float64)
            if s % 16 == 7:
                c = c * 0.3
            elif s % 16 == 11:
                c[60:] -= c[60]
            late = 20 if layout == "churned" and s % 16 == 5 else 0
            ts = BASE_TS + np.arange(late, n_samples,
                                     dtype=np.int64) * INTERVAL_MS
            if layout == "offgrid":
                ts = ts + rng.integers(1, 900, len(ts))
            c = c[late:]
            bs[s % nsh].add_batch(
                {"_metric_": "h", "host": f"h{s % 8}", "inst": f"i{s}"}, ts,
                {"sum": np.diff(c, axis=1, prepend=0.0) @ mids,
                 "count": c[:, -1], "h": c})
        conts = [b.build() for b in bs]
        for ms in stores:
            for shard, cont in enumerate(conts):
                ms.ingest("p", shard, cont)
    for ms in stores:
        ms.flush_all()


def phase_hist_general_small(torch, np, fg, fr, pkg, devs=("cuda", "cpu")):
    """Phase 9a: the general histogram mix on the card against the CPU
    engine over five datasets; K2 launches only for K2-route answers and
    K1 for the fused legs. Returns (queries, K1 launches, K2 launches)."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, PROM_HISTOGRAM, \
        QueryEngine = pkg
    start, end, step = BASE_TS + 300_000, BASE_TS + 990_000, 30_000
    t_inst = BASE_TS + 700_000
    n_q = k1_all = k2_all = 0
    for mode, layout in HIST_GENERAL_SETS:
        engines, stores = {}, []
        for dev in devs:
            ms = TimeSeriesMemStore(device=dev)
            for shard in range(2 if layout == "two_shard" else 1):
                ms.setup("p", PROM_HISTOGRAM, shard, StoreConfig(
                    max_series_per_shard=1024, samples_per_series=128,
                    flush_batch_size=10**9, compressed_residency=mode,
                    device=dev))
            stores.append(ms)
            engines[dev] = QueryEngine(ms, "p", device=dev)
        ingest_hist_general(RecordBuilder, PROM_HISTOGRAM, stores, np, layout)
        st = stores[0].shard("p", 0).store
        assert st.is_narrow_resident == (mode == "all"), (mode, layout)
        card, cpu = engines[devs[0]], engines[devs[1]]
        # the main path: counts from 0, read right after
        reset_k1(fg)
        fr.fused_hist_kernel.launches = 0
        got = {q: card.query_range(q, start, end, step)
               for q in HIST_GENERAL_QUERIES}
        got_i = {q: card.query_instant(q, t_inst)
                 for q in HIST_GENERAL_INSTANT}
        k1, k2 = fg.fused_grid_kernel.launches, fr.fused_hist_kernel.launches
        answers = list(got.values()) + list(got_i.values())
        k2_route = sum(r.exec_path.startswith("fused-hist-narrow")
                       for r in answers)
        fused = sum(r.stats.fused_kernels for r in answers)
        assert k2 == k2_route and k1 == fused - k2_route, \
            (mode, layout, k1, k2, fused, k2_route)
        aligned = layout == "aligned"
        assert k2_route == (2 if aligned and mode == "all" else 0), \
            (mode, layout, k2_route)
        # two fused legs on every grid-aligned shard
        legs = 0 if layout == "offgrid" else 2 * len(stores[0].shards_of("p"))
        assert k1 == legs, (mode, layout, k1)
        for q, g in list(got.items()) + [(f"instant {q}", r)
                                         for q, r in got_i.items()]:
            r = (cpu.query_instant(q[8:], t_inst) if q.startswith("instant")
                 else cpu.query_range(q, start, end, step))
            # the fused-hist routes keep phase 6's quantile bar: their
            # partials agree to 1e-5 and the interpolation divides by one
            # bucket's count difference
            fused_hist = g.exec_path.startswith("fused-hist")
            compare_result(np, f"{mode} {layout} {q}", g, r,
                           q.removeprefix("instant ") in HIST_GENERAL_EXACT,
                           rtol=1e-3 if fused_hist else 1e-5, route=None)
            assert g.matrix.num_series > 0, (mode, layout, q)
        n_q += len(answers)
        k1_all += k1
        k2_all += k2
    return n_q, k1_all, k2_all


# phase 9b's queries over phase 7's store (39 steps at 60 s)
HIST_SCALE_GENERAL = {
    "H1": "sum(rate(req_latency[5m]))",
    "H2": "histogram_quantile(0.9, rate(req_latency[5m]))",
    "H3": ('sum(rate(req_latency{__col__="sum"}[5m])) / '
           'sum(rate(req_latency{__col__="count"}[5m]))'),
}


def prom_hist_rate(np, cells, t_out, window_ms):
    """Per-bucket counter rate of one grid row's cumulative counts
    ``cells`` [C, B] (sample i at BASE_TS + i * INTERVAL_MS, no resets) at
    the steps ``t_out``, written out in f64 after Prometheus'
    extrapolatedRate, over the repo's windows [t - w, t]: [T, B], NaN
    below two samples."""
    C, B = cells.shape
    ts = BASE_TS + np.arange(C, dtype=np.int64) * INTERVAL_MS
    out = np.full((len(t_out), B), np.nan)
    for k, t in enumerate(t_out):
        idx = np.nonzero((ts >= t - window_ms) & (ts <= t))[0]
        if len(idx) < 2:
            continue
        first, last = cells[idx[0]], cells[idx[-1]]
        delta = last - first
        sampled = (ts[idx[-1]] - ts[idx[0]]) / 1000.0
        avg = sampled / (len(idx) - 1)
        dur_start = (ts[idx[0]] - (t - window_ms)) / 1000.0
        dur_end = (t - ts[idx[-1]]) / 1000.0
        for b in range(B):
            ds = dur_start
            if delta[b] > 0 and first[b] >= 0:
                ds = min(ds, sampled * first[b] / delta[b])
            ext = (sampled + (ds if ds < avg * 1.1 else avg / 2)
                   + (dur_end if dur_end < avg * 1.1 else avg / 2))
            out[k, b] = delta[b] * ext / sampled / (window_ms / 1000.0)
    return out


def prom_bucket_quantile(np, q, les, counts):
    """Prometheus' bucketQuantile over cumulative bucket counts [B] in
    f64: NaN for an empty histogram, the highest finite bound when the
    rank falls in the +Inf bucket, else linear within the bucket."""
    total = counts[-1]
    if not total > 0:
        return np.nan
    rank = q * total
    b = int(np.argmax(counts >= rank))
    if b == len(les) - 1:
        return les[-2]
    lo_le, lo_cnt = (0.0, 0.0) if b == 0 else (les[b - 1], counts[b - 1])
    return lo_le + (les[b] - lo_le) * (rank - lo_cnt) / (counts[b] - lo_cnt)


def phase_hist_general_scale(torch, np, fg, fr, card, engine, shard,
                             sampled):
    """Phase 9b: H1-H3 through phase 7's engine on its store, each held
    against an independent computation; returns ({name: p50 ms}, K1
    launches)."""
    st = shard.store
    S, B = HIST_SERIES, HIST_BUCKETS
    out_ts = np.arange(HIST_START, HIST_END + 1, HIST_STEP_MS,
                       dtype=np.int64)
    T = len(out_ts)

    def run(name):
        return engine.query_range(HIST_SCALE_GENERAL[name], HIST_START,
                                  HIST_END, HIST_STEP_MS)

    for name in HIST_SCALE_GENERAL:            # first calls: load + warm
        run(name)
    # the main path: counts from 0, read right after
    reset_k1(fg)
    fr.fused_hist_kernel.launches = 0
    res, lat, k1 = {}, {}, {}
    for name in HIST_SCALE_GENERAL:
        before = fg.fused_grid_kernel.launches
        times = []
        for _ in range(SCALE_GENERAL_REPS):
            t0 = time.perf_counter()
            res[name] = run(name)
            times.append((time.perf_counter() - t0) * 1000)
        lat[name] = float(np.percentile(times, 50))
        k1[name] = (fg.fused_grid_kernel.launches - before) / SCALE_GENERAL_REPS
        assert k1[name] == res[name].stats.fused_kernels, (name, k1[name])
        assert res[name].exec_path == "local", (name, res[name].exec_path)
    assert fr.fused_hist_kernel.launches == 0, fr.fused_hist_kernel.launches
    assert k1 == {"H1": 0, "H2": 0, "H3": 2}, k1
    launches = fg.fused_grid_kernel.launches

    # H1 against K2's partials plus the pool correction at the same query
    data, dd, first_d, n, gids, gids_t, corr, ops, out_eval, _T = \
        hist_scale_operands(torch, np, fr, engine, shard)
    ps, _pc = fr.fused_hist_kernel("rate", WINDOW_MS, INTERVAL_MS, dd,
                                   first_d, n, gids_t, ops, 8)
    want1 = (ps[0].reshape(-1, B)[:T].double()
             + corr[0][0].reshape(-1, B)[:T].double()).cpu().numpy()
    v1 = np.asarray(res["H1"].matrix.values, np.float64)
    assert v1.shape == (1, T, B) and np.isfinite(v1).all(), v1.shape
    np.testing.assert_array_equal(res["H1"].matrix.bucket_les,
                                  data.bucket_les)
    scale1 = float(np.abs(want1).max())
    np.testing.assert_allclose(v1[0], want1, rtol=1e-5, atol=1e-5 * scale1,
                               err_msg="H1")
    err1 = float(np.abs(v1[0] - want1).max() / scale1)

    # H2 against a per-bucket Prometheus rate and quantile over the sampled
    # rows' cells as installed. The engine's histogram grid path computes
    # the rates in f32, as the JAX package does on an f32 store, and the
    # interpolation divides their error by one bucket's count difference:
    # rtol 1e-4, a tenth of phase 7's quantile bar
    les = np.asarray(data.bucket_les, np.float64)
    v2 = np.asarray(res["H2"].matrix.values, np.float64)
    assert v2.shape == (S, T), v2.shape
    keys = res["H2"].matrix.keys
    want2 = np.empty((len(HIST_SAMPLE_ROWS), T))
    for i, row in enumerate(HIST_SAMPLE_ROWS):
        assert keys[row].as_dict()["host"] == f"h{row}", (row, keys[row])
        rates = prom_hist_rate(np, sampled[i].astype(np.float64), out_ts,
                               WINDOW_MS)
        want2[i] = [prom_bucket_quantile(np, 0.9, les, r) for r in rates]
    got2 = v2[list(HIST_SAMPLE_ROWS)]
    np.testing.assert_array_equal(np.isnan(got2), np.isnan(want2))
    np.testing.assert_allclose(got2, want2, rtol=1e-4, equal_nan=True,
                               err_msg="H2")
    fin = np.isfinite(want2)
    err2 = float(np.abs(got2[fin] / want2[fin] - 1).max())

    # H3 against the quotient of its legs (the join divides their f32
    # sums), each leg against K1's plain twin on the column
    legs = {}
    for col in ("sum", "count"):
        q = f'sum(rate(req_latency{{__col__="{col}"}}[5m]))'
        legs[col] = np.asarray(engine.query_range(
            q, HIST_START, HIST_END, HIST_STEP_MS).matrix.values)
        Tp = -(-T // 128) * 128
        band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
            HIST_CAPACITY, Tp, out_ts.tobytes(), WINDOW_MS, BASE_TS,
            INTERVAL_MS, "rate", False, st.n.device)
        plain = fg.PaddedPartials(fg.fused_grid_aggregate_plain(
            "rate", False, WINDOW_MS, INTERVAL_MS, st.extra[col], st.n,
            fg.zero_gids(st.S, st.n.device), band, ohlo, lo, hi, rel, 8, c0,
            Ca), "sum", 8, T).resolve()
        ref = np.asarray(plain["sum"][:1], np.float64)
        np.testing.assert_allclose(legs[col], ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=f"H3 {col} leg")
    want3 = (legs["sum"] / legs["count"]).astype(np.float64)
    v3 = np.asarray(res["H3"].matrix.values, np.float64)
    assert v3.shape == (1, T) and np.isfinite(v3).all(), v3.shape
    np.testing.assert_allclose(v3, want3, rtol=float(np.finfo(np.float32).eps),
                               err_msg="H3")
    log(f"hist general scale [{card}]: {S} histograms x {T} steps x {B} "
        f"buckets; H1 max diff to K2 + pool correction {err1:.3g} of the "
        f"largest sum; H2 max rel diff to the written-out quantile "
        f"{err2:.3g} over {len(HIST_SAMPLE_ROWS)} rows; H3 max rel diff to "
        f"its legs {float(np.abs(v3 / want3 - 1).max()):.3g}")
    for name, q in HIST_SCALE_GENERAL.items():
        log(f"hist general scale [{card}]: {name} {q}: p50 {lat[name]:.3f} "
            f"ms over {SCALE_GENERAL_REPS} runs, K1 launches a query "
            f"{k1[name]:g}")
    return lat, launches


# ---- phase 10: subqueries and @ ---------------------------------------------

def phase_subquery_scale(torch, np, fg, card, engine, shard):
    """Phase 10: Q1-Q3 through phase 4's engine on its store (bench range
    variant 0), each held against an independent computation over its
    inner query's own answer; returns ({name: p50 ms}, K1 launches)."""
    S = shard.num_series
    s, e = range_variants(shard)[0]
    assert e % 1000 == 0, e
    out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
    T = len(out_ts)
    queries = {
        "Q1": "max_over_time(sum(rate(m[5m]))[30m:1m])",
        "Q2": f"sum(rate(m[5m] @ {e // 1000}))",
        "Q3": 'avg_over_time(rate(m{host=~"h1.*"}[5m])[10m:1m])',
    }
    # a per-series answer over 159,687 series x 47 steps
    engine.config.sample_limit = max(engine.config.sample_limit, S * 64)

    def run(name):
        return engine.query_range(queries[name], s, e, STEP_MS)

    for name in queries:                        # first calls: load + warm
        run(name)
    # the main path: counts from 0, read right after
    reset_k1(fg)
    res, lat, k1 = {}, {}, {}
    for name in queries:
        before = fg.fused_grid_kernel.launches
        times = []
        for _ in range(SCALE_GENERAL_REPS):
            t0 = time.perf_counter()
            res[name] = run(name)
            times.append((time.perf_counter() - t0) * 1000)
        lat[name] = float(np.percentile(times, 50))
        k1[name] = (fg.fused_grid_kernel.launches - before) / SCALE_GENERAL_REPS
        assert k1[name] == res[name].stats.fused_kernels, (name, k1[name])
        assert res[name].exec_path == "local", (name, res[name].exec_path)
    assert k1 == {"Q1": 1, "Q2": 0, "Q3": 0}, k1
    launches = fg.fused_grid_kernel.launches

    def inner_grid(rng):
        sub = 60_000
        return ((s - rng) // sub + 1) * sub, (e // sub) * sub, sub

    def windows(sub_ts, rng):
        """Each outer step's inner cells, the repo's windows [t - w, t]."""
        return [(sub_ts >= t - rng) & (sub_ts <= t) for t in out_ts]

    # Q1: a windowed max written out over the inner query's 1m-grid answer
    inner1 = engine.query_range("sum(rate(m[5m]))", *inner_grid(1_800_000))
    iv = np.asarray(inner1.matrix.values, np.float64)[0]
    want1 = np.array([iv[w][np.isfinite(iv[w])].max()
                      for w in windows(inner1.matrix.out_ts, 1_800_000)])
    v1 = np.asarray(res["Q1"].matrix.values, np.float64)
    assert v1.shape == (1, T), v1.shape
    assert np.array_equal(v1[0], want1), ("Q1", v1[0, :4], want1[:4])
    # Q2: every step bit for bit the instant query at the pinned time, and
    # within K1's bar of the fused sum at that time
    v2 = np.asarray(res["Q2"].matrix.values, np.float64)
    pinned = np.asarray(engine.query_instant(queries["Q2"], e).matrix.values,
                        np.float64)
    assert v2.shape == (1, T) and pinned.shape == (1, 1), (v2.shape,
                                                           pinned.shape)
    assert np.array_equal(v2[0], np.repeat(pinned[0], T)), ("Q2", v2[0, :4],
                                                            pinned)
    fused = np.asarray(engine.query_instant("sum(rate(m[5m]))", e)
                       .matrix.values, np.float64)
    np.testing.assert_allclose(v2[0, 0], fused[0, 0], rtol=1e-5,
                               err_msg="Q2")
    # Q3: a windowed mean of the inner matrix, in torch on the card
    inner3 = engine.query_range('rate(m{host=~"h1.*"}[5m])',
                                *inner_grid(600_000))
    iv3 = torch.from_numpy(np.asarray(inner3.matrix.values,
                                      np.float64)).cuda()
    want3 = torch.empty((iv3.shape[0], T), dtype=torch.float64,
                        device=iv3.device)
    for k, w in enumerate(windows(inner3.matrix.out_ts, 600_000)):
        x = iv3[:, torch.from_numpy(w).cuda()]
        ok = torch.isfinite(x)
        want3[:, k] = (torch.where(ok, x, 0.0).sum(1)
                       / ok.sum(1).double())    # 0/0: NaN, an empty window
    want3 = want3.cpu().numpy()
    v3 = np.asarray(res["Q3"].matrix.values, np.float64)
    n3 = res["Q3"].matrix.num_series
    # the hosts h0 .. h{S-1} whose name starts "h1": 159,687 of 2^20
    assert v3.shape == want3.shape == (n3, T) and n3 == sum(
        str(i).startswith("1") for i in range(S)), (v3.shape, want3.shape)
    assert res["Q3"].stats.subquery_inner_cells == n3 * len(
        inner3.matrix.out_ts), res["Q3"].stats.subquery_inner_cells
    np.testing.assert_array_equal(np.isnan(v3), np.isnan(want3))
    np.testing.assert_allclose(v3, want3, rtol=1e-9, equal_nan=True,
                               err_msg="Q3")
    fin = np.isfinite(want3)
    log(f"subquery scale [{card}]: {S} series x {T} steps; Q1 exact; Q2 "
        f"{float(v2[0, 0])!r} at every step, rel diff to K1's sum "
        f"{abs(v2[0, 0] / fused[0, 0] - 1):.3g}; Q3 {n3} series, max rel "
        f"diff {float(np.abs(v3[fin] / want3[fin] - 1).max()):.3g}")
    for name, q in queries.items():
        log(f"subquery scale [{card}]: {name} {q}: p50 {lat[name]:.3f} ms "
            f"over {SCALE_GENERAL_REPS} runs, K1 launches a query "
            f"{k1[name]:g}")
    return lat, launches


# phase 11a: the mesh route on 8 small shards, card against CPU
MESH_SMALL_N = 100
MESH_SMALL_FUSED = tuple(f"{op}({fn}(c[5m]))"
                         for op in ("sum", "avg", "count", "stddev")
                         for fn in ("rate", "increase", "delta")) + (
    "sum(sum_over_time(c[5m]))", "avg by (grp) (rate(c[5m]))")
MESH_SMALL_ROUTES = (
    [("c", q, "mesh-fused") for q in MESH_SMALL_FUSED]
    + [("c", q, "mesh-twostep") for q in ("max(rate(c[5m]))",
                                          "min by (grp) (rate(c[5m]))")]
    + [("c", q, "mesh-topk") for q in ("topk(3, rate(c[5m]))",
                                       "bottomk(2, rate(c[5m]))",
                                       "topk(2, rate(c[5m])) by (grp)")]
    + [("c", "quantile(0.9, rate(c[5m]))", "mesh-sketch"),
       ("c", "sum(rate(nosuch[5m]))", "mesh-empty")]
    + [(kind, q, "mesh-fused-narrow") for kind in NARROW_KINDS
       for q in ("sum(rate(c[5m]))", "stddev by (grp) (increase(c[5m]))")]
    + [("pool", "sum(rate(c[5m]))", "mesh-fused"),
       ("mirror", "sum(rate(c[5m]))", "local")])


def mesh_small_rows(np, kind, n, seed):
    """``n`` value rows of MESH_SMALL_N samples: integer counters (the
    ``c``, ``delta8``, ``pool`` and ``mirror`` sets), half-integer gauges
    (``quant16``) or wide odd increments (``delta16``); in ``pool`` the
    third row of every 5 is continuous (no variant carries it)."""
    rng = np.random.default_rng(seed)
    N = MESH_SMALL_N
    out = []
    for i in range(n):
        if kind == "quant16":
            v = 1000.0 + 0.5 * np.arange(N) + 4.0 * i
        elif kind == "delta16":
            v = np.cumsum(rng.integers(100, 3000, N) * 2 + 1).astype(float)
        elif kind == "pool" and i % 5 == 2:
            v = np.cumsum(rng.exponential(5.0, N))
        else:
            v = np.cumsum(rng.integers(1, 50, N)).astype(float)
        out.append(v)
    return out


def build_mesh_small(np, pkg, dev):
    """One memstore on ``dev``: the datasets phase 11a queries, each through
    the real ingest path and a flush. ``c``: 8 shards of 3, 6, ..., 24
    integer counters; one 8-shard "gauge" dataset of 3 series a shard per
    decode kind; ``pool``: 8 "gauge" shards of 5 counters, one continuous
    (the cohort pool); ``mirror``: one raw shard of 24 counters with the
    quant16 mirror on."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, _qe = pkg
    ms = TimeSeriesMemStore(device=dev)
    ts = BASE_TS + np.arange(MESH_SMALL_N, dtype=np.int64) * INTERVAL_MS
    sets = {"c": (8, None, "off", False)}
    sets.update({k: (8, 3, "gauge", False) for k in NARROW_KINDS})
    sets["pool"] = (8, 5, "gauge", False)
    sets["mirror"] = (1, 24, "off", True)
    for ds, (nshards, per, residency, mirror) in sets.items():
        cfg = StoreConfig(max_series_per_shard=32, samples_per_series=128,
                          flush_batch_size=10**9,
                          compressed_residency=residency,
                          narrow_mirror=mirror, device=dev)
        shards = [ms.setup(ds, GAUGE, s, cfg) for s in range(nshards)]
        counts = ([3 * (s + 1) for s in range(nshards)] if per is None
                  else [per] * nshards)
        rows = mesh_small_rows(np, ds, sum(counts), seed=21)
        i = 0
        for s, sh in enumerate(shards):
            b = RecordBuilder(GAUGE)
            for _ in range(counts[s]):
                b.add_batch({"_metric_": "c", "host": f"h{i}",
                             "grp": f"g{i % 4}"}, ts, rows[i])
                i += 1
            sh.ingest(b.build())
            sh.flush()
    return ms


def phase_mesh_small(torch, np, fg, pkg, devs=("cuda", "cpu")):
    """Phase 11a: every mesh route (and the pool-row and mirror cases) with
    QueryEngine(mesh=["cuda"]) against QueryEngine(mesh=["cpu"] * 8) over
    the same data: route, QueryStats, keys, NaN placement and values
    (counts bit for bit, the rest rtol 1e-5 of the largest magnitude).
    Returns K1's launches on the card by decode variant."""
    QueryEngine = pkg[4]
    stores = {dev: build_mesh_small(np, pkg, dev) for dev in devs}
    meshes = {devs[0]: [devs[0]], devs[1]: [devs[1]] * 8}
    for kind in NARROW_KINDS:
        for dev in devs:
            for sh in stores[dev].shards_of(kind):
                nd = sh.store.narrow_operands()
                assert nd is not None and nd[0] == kind and nd[2].all(), \
                    (kind, dev, nd and nd[0])
    for dev in devs:
        pool = [sh.store.narrow_operands() for sh in stores[dev].shards_of(
            "pool")]
        assert all(nd is not None for nd in pool) and not all(
            nd[2][:5].all() for nd in pool), dev
        mirror = stores[dev].shard("mirror", 0).store
        assert mirror.narrow.get(mirror) is not None, dev
    start, end, step = BASE_TS + 300_000, BASE_TS + 990_000, 30_000
    engines = {(dev, ds): QueryEngine(stores[dev], ds, device=dev,
                                      mesh=meshes[dev])
               for dev in devs for ds in ("c", "pool", "mirror",
                                          *NARROW_KINDS)}
    # the main path: counts from 0, read right after
    reset_k1(fg)
    got = [engines[(devs[0], ds)].query_range(q, start, end, step)
           for ds, q, _route in MESH_SMALL_ROUTES]
    by_kind = dict(fg.fused_grid_kernel.launches_by_kind)
    want = dict.fromkeys(by_kind, 0)
    for (ds, _q, route), r in zip(MESH_SMALL_ROUTES, got):
        assert r.exec_path == route, (ds, _q, r.exec_path, route)
        if route.startswith("mesh-fused"):
            want["raw" if ds in ("c", "pool") else ds] += 8
    want["quant16"] += 1                       # the mirror's single shard
    assert by_kind == want, (by_kind, want)
    for (ds, q, route), r in zip(MESH_SMALL_ROUTES, got):
        ref = engines[(devs[1], ds)].query_range(q, start, end, step)
        exact = q.startswith("count") or route == "mesh-empty"
        compare_result(np, f"{ds}: {q}", r, ref, exact, route=route)
        if ds == "mirror":
            assert r.stats.blocks_narrow == 1, r.stats.blocks_narrow
    return by_kind


# phase 11b: the bench's shape split over 8 shards, mesh against host loop
MESH_SHARDS = 8
MESH_SERIES = NUM_SERIES // MESH_SHARDS
MESH_QUERIES = {
    "M1": "sum(rate(m[5m]))",
    "M2": "avg by (grp) (rate(m[5m]))",
    "M3": "max(rate(m[5m]))",
    "M4": "topk(5, rate(m[5m]))",
    "M5": "quantile(0.99, rate(m[5m]))",
    "M6": "sum(rate(m[5m]))",
}
MESH_ROUTES = {"M1": "mesh-fused", "M2": "mesh-fused", "M3": "mesh-twostep",
               "M4": "mesh-topk", "M5": "mesh-sketch",
               "M6": "mesh-fused-narrow"}
MESH_REPS = 3
# M2 (~5.8 s a query of Python group keys) runs once on each engine, with
# no warm run: the cut that makes room for phase 13
MESH_REPS_BY = {"M2": 1}


def build_mesh_scale(torch, np, pkg, dev="cuda"):
    """(memstore, shards, registration s): bench.py's 2^20 series x 720
    samples (C = 768) split over 8 shards of 2^17, every series registered
    through the real ingest path (``add_series_batch`` -> ``shard.ingest``
    -> ``discard_staged``), the data installed on the card from a seeded
    torch.Generator: counters with integer anchors below 2^20 and integer
    increments in [0, 8], which delta8 carries exactly (no pool row).
    Residency is "off" until M6 turns it on."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, _qe = pkg
    ms = TimeSeriesMemStore(device=dev)
    cfg = StoreConfig(max_series_per_shard=MESH_SERIES,
                      samples_per_series=CAPACITY, flush_batch_size=10**9,
                      device=dev)
    shards = [ms.setup("meshq", GAUGE, s, cfg) for s in range(MESH_SHARDS)]
    t0 = time.perf_counter()
    for s, sh in enumerate(shards):
        ids = range(s * MESH_SERIES, (s + 1) * MESH_SERIES)
        b = RecordBuilder(GAUGE)
        b.add_series_batch({"_metric_": "m", "host": [f"h{i}" for i in ids],
                            "grp": [f"g{i % 4}" for i in ids]}, BASE_TS, 0.0)
        sh.ingest(b.build())
        sh.discard_staged()
        assert sh.num_series == MESH_SERIES, sh.num_series
    reg_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(23)
    row = BASE_TS + torch.arange(NUM_SAMPLES, device=dev) * INTERVAL_MS
    for sh in shards:
        st = sh.store
        with sh.lock:
            for r0 in range(0, MESH_SERIES, DATA_BATCH):
                rows = min(DATA_BATCH, MESH_SERIES - r0)
                inc = torch.randint(0, 9, (rows, NUM_SAMPLES), generator=g,
                                    device=dev).float()
                base = torch.randint(0, 1 << 20, (rows, 1), generator=g,
                                     device=dev).float()
                st.val[r0:r0 + rows, :NUM_SAMPLES] = base + torch.cumsum(
                    inc, 1)
            st.val[:, NUM_SAMPLES:] = 0.0
            st.ts[:, :NUM_SAMPLES] = row
            st.n.fill_(NUM_SAMPLES)
            st.n_host[:] = NUM_SAMPLES
            st.first_ts[:] = BASE_TS
            st.last_ts[:] = BASE_TS + (NUM_SAMPLES - 1) * INTERVAL_MS
            st.grid_base, st.grid_interval = BASE_TS, INTERVAL_MS
            st.grid_ok = True
            st.stats.samples_appended += MESH_SERIES * NUM_SAMPLES
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return ms, shards, reg_s


def mesh_answer(np, r):
    return {k.labels: np.asarray(v, np.float64)
            for k, _t, v in r.matrix.iter_series()}


def mesh_k1_per_shard(np, fg, shards, out_ts):
    """K1's time on each shard's raw block at ``out_ts`` (CUDA events)."""
    T = len(out_ts)
    Tp = -(-T // 128) * 128
    out = []
    for sh in shards:
        st = sh.store
        _band, _ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
            CAPACITY, Tp, out_ts.tobytes(), WINDOW_MS, BASE_TS, INTERVAL_MS,
            "rate", False, st.val.device)
        gz = fg.zero_gids(st.S, st.val.device)
        out.append(cuda_ms(lambda st=st, gz=gz, lo=lo, hi=hi, rel=rel,
                           c0=c0, Ca=Ca: fg.fused_grid_kernel(
            "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gz, lo, hi,
            rel, 8, c0, Ca), reps=10))
    return out


def phase_mesh_scale(torch, np, fg, card, pkg, k1_single_ms, dev="cuda"):
    """Phase 11b: M1-M6 through QueryEngine(mesh=["cuda"]) and the host
    loop (QueryEngine without a mesh) on one 8-shard memstore; routes, K1's
    launches a query, the mesh answer against the host loop's (M1-M3, M6
    bit for bit; M4 keys equal and values bit for bit; M5 the presented
    quantiles bit for bit, every series counted once a step); p50 over 3
    runs each after a warm run; the 8 per-shard K1 times beside phase 4's
    single-shard K1 over the same 2^20 rows. Returns K1's launches on the
    mesh runs by decode variant, the p50s, the per-shard K1 times and the
    8 shards (delta8-resident since M6: phase 14b adopts them)."""
    QueryEngine = pkg[4]

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
    ms, shards, reg_s = build_mesh_scale(torch, np, pkg, dev)
    mesh_eng = QueryEngine(ms, "meshq", device=dev, mesh=[dev])
    host_eng = QueryEngine(ms, "meshq", device=dev)
    s, e = range_variants(shards[0])[0]
    T = len(np.arange(s, e + 1, STEP_MS))

    def timed(eng, q, reps):
        if reps > 1:
            eng.query_range(q, s, e, STEP_MS)        # warm
        times, r = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            r = eng.query_range(q, s, e, STEP_MS)
            np.asarray(r.matrix.values)
            times.append((time.perf_counter() - t0) * 1000)
        return r, float(np.percentile(times, 50))

    out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
    lat, res, host, launches = {}, {}, {}, {}
    by_kind = dict.fromkeys(fg.fused_grid_kernel.launches_by_kind, 0)
    for name, q in MESH_QUERIES.items():
        if name == "M6":
            # before the store goes narrow: the 8 per-shard K1 launches of
            # M1 by CUDA events, and M5's sketch counts
            per_shard = mesh_k1_per_shard(np, fg, shards, out_ts)
            with contextlib.ExitStack() as stack:
                for sh in shards:
                    stack.enter_context(sh.lock)
                ex = mesh_eng._mesh_executor(shards)
                sketch = ex.quantile("rate", out_ts, WINDOW_MS,
                                     [np.zeros(MESH_SERIES, np.int32)]
                                     * MESH_SHARDS, 1, 0.99)
            # every series counted once at every step
            assert (sketch.counts[0].sum(axis=0)[:T] == NUM_SERIES).all()
            comp_s = mesh_scale_delta8(torch, shards, dev)
        reps = MESH_REPS_BY.get(name, MESH_REPS)
        if reps > 1:
            mesh_eng.query_range(q, s, e, STEP_MS)   # warm
        # the main path: counts from 0, read right after
        reset_k1(fg)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = mesh_eng.query_range(q, s, e, STEP_MS)
            np.asarray(r.matrix.values)
            times.append((time.perf_counter() - t0) * 1000)
        for k, v in fg.fused_grid_kernel.launches_by_kind.items():
            by_kind[k] += v
        launches[name] = fg.fused_grid_kernel.launches / reps
        res[name], lat[name] = r, float(np.percentile(times, 50))
        host[name], lat[name + " host"] = timed(host_eng, q, reps)
        assert r.exec_path == MESH_ROUTES[name], (name, r.exec_path)
        assert host[name].exec_path == "local", host[name].exec_path
        want = 8 if MESH_ROUTES[name].startswith("mesh-fused") else 0
        assert launches[name] == want, (name, launches[name])
        assert r.stats.fused_kernels == (want > 0), name
        assert r.stats.series_matched == NUM_SERIES, r.stats.series_matched
    for name in MESH_QUERIES:
        g, h = res[name], host[name]
        if name == "M4":
            ga, ha = mesh_answer(np, g), mesh_answer(np, h)
            assert set(ga) == set(ha), "M4 keys"
            assert all(np.array_equal(ga[k], ha[k], equal_nan=True)
                       for k in ha), "M4 values"
        else:
            assert [k.labels for k in g.matrix.keys] == \
                [k.labels for k in h.matrix.keys], name
            assert np.array_equal(np.asarray(g.matrix.values),
                                  np.asarray(h.matrix.values),
                                  equal_nan=True), (name, "not bit-equal")
        vals = np.asarray(g.matrix.values, np.float64)
        assert vals.shape[1] == T and np.isfinite(vals[~np.isnan(vals)]
                                                  ).all(), name
    assert res["M4"].matrix.num_series >= 5
    assert res["M2"].matrix.num_series == 4
    log(f"mesh scale [{card}]: {MESH_SHARDS} shards x {MESH_SERIES} series "
        f"x {NUM_SAMPLES} samples registered in {reg_s:.1f} s; {T} steps; "
        f"delta8 at flush in {comp_s:.2f} s")
    for name, q in MESH_QUERIES.items():
        log(f"mesh scale [{card}]: {name} {q}: {MESH_ROUTES[name]} p50 "
            f"{lat[name]:.3f} ms, host loop p50 {lat[name + ' host']:.3f} "
            f"ms (over {MESH_REPS_BY.get(name, MESH_REPS)} runs); K1 "
            f"launches a mesh query "
            f"{launches[name]:g}; bit-equal to the host loop")
    log(f"mesh scale [{card}]: K1 per shard (2^17 rows) by CUDA events "
        f"{[round(x, 4) for x in per_shard]} ms, sum "
        f"{sum(per_shard):.4f} ms, beside phase 4's one launch over 2^20 "
        f"rows {k1_single_ms:.4f} ms")
    return by_kind, lat, per_shard, shards


def mesh_scale_delta8(torch, shards, dev="cuda") -> float:
    """Seconds to turn phase 11b's shards delta8-resident at a flush (the
    exact counters leave no pool row)."""
    shards[0].config.compressed_residency = "gauge"
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for sh in shards:
        sh.flush()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    for sh in shards:
        nd = sh.store.narrow_operands()
        assert nd is not None and nd[0] == "delta8" and nd[2].all(), \
            nd and nd[0]
    return time.perf_counter() - t0


def phase_mirror_scale(torch, np, fg, card, engine, shard):
    """NarrowMirror on phase 4's raw shard, after every phase that times
    it: the mirror on, one sample appended through the real path and
    flushed (the flush rebuilds the mirror outside the lock). On phase 4's
    continuous values no row round-trips and the query streams the raw
    block; then the store's values are rounded to integers in place (a
    direct write, as phase 4's install is), another flush rebuilds the
    mirror, every row is exact, and sum(rate(m[5m])) streams K1-quant16,
    within 1e-5 of the raw route's answer. Returns the quant16 launches."""
    from filodb_tpu_torch.core.filters import Equals
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import GAUGE
    st = shard.store
    s, e = range_variants(shard)[0]
    q = "sum(rate(m[5m]))"
    (pid,) = shard.part_ids_from_filters([Equals("host", "h0")], s, e)
    shard.config.narrow_mirror = True

    def append_and_flush():
        n = int(st.n_host[pid])
        b = RecordBuilder(GAUGE)
        b.add({"_metric_": "m", "host": "h0"}, BASE_TS + n * INTERVAL_MS,
              float(st.val[pid, n - 1]) + 1.0)
        shard.ingest(b.build())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shard.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run(mirror):
        shard.config.narrow_mirror = mirror
        reset_k1(fg)
        r = engine.query_range(q, s, e, STEP_MS)
        kinds = dict(fg.fused_grid_kernel.launches_by_kind)
        shard.config.narrow_mirror = True
        return r, kinds

    t_float = append_and_flush()
    ok = st.narrow.get(st)[3]
    r, kinds = run(True)
    assert r.stats.blocks_raw == 1 and kinds["raw"] == 1, (r.stats.blocks_raw,
                                                           kinds)
    with shard.lock:
        st.val.round_()
        st.stats.samples_appended += NUM_SERIES * NUM_SAMPLES
    assert st.narrow.get(st) is None            # stale until a flush
    t_int = append_and_flush()
    ok_int = st.narrow.get(st)[3]
    assert ok_int.all(), int((~ok_int).sum())
    got, kinds = run(True)
    assert got.stats.blocks_narrow == 1 and kinds["quant16"] == 1 and \
        kinds["raw"] == 0, (got.stats.blocks_narrow, kinds)
    launches = kinds["quant16"]
    raw, kinds = run(False)
    assert raw.stats.blocks_raw == 1 and kinds["raw"] == 1, kinds
    gv, rv = (np.asarray(x.matrix.values, np.float64) for x in (got, raw))
    np.testing.assert_allclose(gv, rv, rtol=1e-5,
                               atol=1e-5 * float(np.abs(rv).max()),
                               err_msg="mirror vs raw")
    log(f"mirror scale [{card}]: phase 4's {NUM_SERIES} series; refresh at "
        f"flush {t_float:.2f} s on the continuous values ({int(ok.sum())} "
        f"rows exact: the query streams the raw block), {t_int:.2f} s after "
        f"rounding them to integers (every row exact): sum(rate(m[5m])) "
        f"streams K1-quant16 once, "
        f"{'bit-equal to' if np.array_equal(gv, rv) else 'within 1e-5 of'} "
        f"the raw route (max |diff| {float(np.abs(gv - rv).max()):.3g})")
    shard.config.narrow_mirror = False
    return launches


# -- phase 12: the engine's serving fast path --------------------------------

SERVE_QUERY = "sum by (dc) (rate(m[2m]))"
SERVE_TYPO = "sum(rate(typo_metric[2m]))"
SERVE_STEP = 30_000
SERVE_RANGE = (BASE_TS + 300_000, BASE_TS + 800_000)
# every cache and the admission gate on (a budget no phase-12 load reaches)
SERVE_CONFIG = dict(result_cache_size=64, negative_cache_size=64,
                    fragment_cache_size=64, max_concurrent_cost=1e13,
                    slow_log_threshold_ms=None)


def serve_ingest_small(RecordBuilder, GAUGE, shard, np, series, c0, n):
    """Cells [c0, c0 + n) of integer counters (increments from a generator
    seeded by the series) through the real ingest path."""
    b = RecordBuilder(GAUGE)
    for i in series:
        vals = np.cumsum(np.random.default_rng(200 + i).integers(
            1, 9, c0 + n))[c0:].astype(np.float64)
        ts = BASE_TS + (c0 + np.arange(n, dtype=np.int64)) * 10_000
        b.add_batch({"_metric_": "m", "host": f"h{i}", "dc": f"dc{i % 2}"},
                    ts, vals)
    shard.ingest(b.build())
    shard.flush()


def serve_record(np, eng, r) -> dict:
    """What phase 12a compares of one answer and the engine's state."""
    m = r.matrix.to_host()
    return {"path": r.exec_path,
            "stats": {f: getattr(r.stats, f) for f in r.stats.FIELDS},
            "keys": [k.labels for k in m.keys], "ts": np.asarray(m.out_ts),
            "vals": np.asarray(m.values, np.float64)[:len(m.keys)],
            "caches": [c.stats() for c in (eng.result_cache,
                                           eng.negative_cache,
                                           eng.fragment_cache)],
            "epochs": eng._epoch_vector()}


def serve_sequence_small(np, fg, pkg, dev, ds):
    """Phase 12a's sequence on one device, in dataset ``ds`` (the caches'
    counters are process-global, tagged by dataset): [(step, record, K1
    launches)] and the metadata answers."""
    from filodb_tpu_torch.core.filters import Equals
    from filodb_tpu_torch.query.engine import QueryConfig
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    ms = TimeSeriesMemStore(device=dev)
    shard = ms.setup(ds, GAUGE, 0, StoreConfig(
        max_series_per_shard=8, samples_per_series=256,
        flush_batch_size=10**9, device=dev))
    serve_ingest_small(RecordBuilder, GAUGE, shard, np, range(6), 0, 90)
    eng = QueryEngine(ms, ds, device=dev,
                      config=QueryConfig(**SERVE_CONFIG))
    s, e = SERVE_RANGE
    out = []

    def run(what, q=SERVE_QUERY, shift=0):
        reset_k1(fg)
        r = eng.query_range(q, s + shift * SERVE_STEP, e + shift * SERVE_STEP,
                            SERVE_STEP)
        out.append((what, serve_record(np, eng, r),
                    fg.fused_grid_kernel.launches))

    run("cold")
    run("repeat")
    run("shift", shift=2)
    serve_ingest_small(RecordBuilder, GAUGE, shard, np, range(6), 90, 30)
    run("shift after a tail ingest", shift=6)
    # three series more than the shard's 8 slots: an eviction releases
    # the least recently active one (a destructive epoch bump)
    serve_ingest_small(RecordBuilder, GAUGE, shard, np, range(6, 9), 100, 20)
    assert shard.stats.partitions_evicted > 0
    run("after a release", shift=6)
    run("typo", SERVE_TYPO)
    run("typo again", SERVE_TYPO)
    meta = (eng.label_values("host"), eng.label_names(),
            eng.series([Equals("dc", "dc1")], 0, 1 << 62),
            [(lbl, ts.tolist(), v.tolist()) for lbl, ts, v in eng.raw_series(
                [Equals("_metric_", "m")], BASE_TS, BASE_TS + 10**7)])
    return out, meta


SERVE_SMALL_ROUTES = ["local", "result-cache[local]",
                      "incremental[reused=15,computed=2]",
                      "incremental[reused=13,computed=4]", "local", "local",
                      "negative-cache"]
SERVE_SMALL_LAUNCHES = [1, 0, 1, 1, 1, 0, 0]


def phase_serving_small(torch, np, fg, pkg, devs=("cuda", "cpu")):
    """Phase 12a: the serving sequence on the card against the CPU: the
    same routes, QueryStats counters, cache stats and epoch vectors, the
    values within rtol 1e-5 of the largest magnitude, the metadata answers
    equal; K1 launched once a step that executes, never on a hit. Returns
    (K1 launches, answers bit-equal to the CPU's, answers)."""
    card, card_meta = serve_sequence_small(np, fg, pkg, devs[0], "serve0")
    cpu, cpu_meta = serve_sequence_small(np, fg, pkg, devs[1], "serve1")
    assert [g["path"] for _w, g, _l in card] == SERVE_SMALL_ROUTES, \
        [g["path"] for _w, g, _l in card]
    bit_equal = 0
    for (what, g, _l), (_w, r, _rl) in zip(card, cpu):
        for k in ("path", "stats", "keys", "caches", "epochs"):
            assert g[k] == r[k], (what, k, g[k], r[k])
        assert np.array_equal(g["ts"], r["ts"]), what
        assert (np.isnan(g["vals"]) == np.isnan(r["vals"])).all(), what
        scale = float(np.nanmax(np.abs(r["vals"]), initial=0.0))
        np.testing.assert_allclose(g["vals"], r["vals"], rtol=1e-5,
                                   atol=1e-5 * scale, equal_nan=True,
                                   err_msg=what)
        bit_equal += bool(np.array_equal(g["vals"], r["vals"],
                                         equal_nan=True))
    if devs[0] == "cuda":
        launches = [n for _w, _g, n in card]
        assert launches == SERVE_SMALL_LAUNCHES, launches
    assert card_meta == cpu_meta
    return sum(n for _w, _g, n in card), bit_equal, len(card)


def serve_time(torch, np, fn):
    """(host ms, result) of one query, its answer copied to the host and
    the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    np.asarray(r.matrix.to_host().values)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000, r


def serve_answer(np, r):
    m = r.matrix.to_host()
    return [k.labels for k in m.keys], np.asarray(m.values, np.float64)


def serve_check(np, what, got, want) -> bool:
    """An answer against the caches-off oracle's: keys, NaN placement,
    values within rtol 1e-5 of the largest magnitude; True when bit-equal."""
    gk, gv = serve_answer(np, got)
    rk, rv = serve_answer(np, want)
    assert gk == rk and gv.shape == rv.shape, (what, gk, rk)
    assert np.array_equal(np.asarray(got.matrix.out_ts),
                          np.asarray(want.matrix.out_ts)), what
    assert (np.isnan(gv) == np.isnan(rv)).all(), what
    scale = float(np.nanmax(np.abs(rv), initial=0.0))
    np.testing.assert_allclose(gv, rv, rtol=1e-5, atol=1e-5 * scale,
                               equal_nan=True, err_msg=what)
    return bool(np.array_equal(gv, rv, equal_nan=True))


def k1_pass_shape(fn, needs_sumsq, window_ms, interval_ms, val, n, gids,
                  band, ohlo, lo, hi, rel, G, c0=0, Ca=None, kind="raw",
                  row_ops=()):
    """(Tp, active columns, G) of one ``fused_grid_partials`` call, from
    its arguments."""
    return int(lo.shape[-1]), int(Ca or val.shape[1]), int(G)


@contextlib.contextmanager
def k1_launch_args(fg, seen: list):
    """Record (Tp, active columns, G) of every K1 pass the engine makes
    (the wrapper's counts are untouched)."""
    real = fg.fused_grid_partials

    def recording(*a, **kw):
        seen.append(k1_pass_shape(*a, **kw))
        return real(*a, **kw)

    fg.fused_grid_partials = recording
    try:
        yield
    finally:
        fg.fused_grid_partials = real


def serve_ingest_scale(np, shard):
    """One new sample for every series of phase 4's store, at each row's
    next grid cell, through RecordBuilder -> shard.ingest -> flush. Rows
    phase 10b appended to are found by their count; every other row of
    bench's registration (host h<i> at row i) takes the next cell after
    NUM_SAMPLES. Returns (seconds, the minimum new timestamp)."""
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import GAUGE
    st = shard.store
    n = st.n_host.copy()
    odd = np.nonzero(n != NUM_SAMPLES)[0]
    with shard.lock:
        odd_hosts = {int(p): shard.index.labels_of(int(p))["host"]
                     for p in odd}
    t0 = time.perf_counter()
    b = RecordBuilder(GAUGE)
    skip = set(odd_hosts.values())
    b.add_series_batch({"_metric_": "m", "host": [
        f"h{i}" for i in range(NUM_SERIES) if f"h{i}" not in skip]},
        BASE_TS + NUM_SAMPLES * INTERVAL_MS, 1e6)
    shard.ingest(b.build())
    for p, h in odd_hosts.items():
        b = RecordBuilder(GAUGE)
        b.add({"_metric_": "m", "host": h}, BASE_TS + int(n[p]) * INTERVAL_MS,
              1e6)
        shard.ingest(b.build())
    shard.flush()
    secs = time.perf_counter() - t0
    assert (st.n_host == n + 1).all(), int((st.n_host != n + 1).sum())
    assert st.grid_info() is not None
    return secs, BASE_TS + NUM_SAMPLES * INTERVAL_MS


SERVE_SCALE_REPS = 3
SERVE_SCALE_SHIFT = 4          # steps a dashboard's window slides


def phase_serving_scale(torch, np, fg, card, engine, shard, dev="cuda"):
    """Phase 12b: the serving fast path over phase 4's store (run after
    every other phase that reads it: its ingest adds a sample). Three
    engines with every cache and admission on; their oracle is phase 4's
    engine (caches off). Returns the K1 launches of the serving path."""
    from filodb_tpu_torch.promql import parser as promql
    from filodb_tpu_torch.query.engine import QueryConfig, QueryEngine
    from concurrent.futures import ThreadPoolExecutor
    q = "sum(rate(m[5m]))"
    s0 = BASE_TS + WINDOW_MS
    e0 = BASE_TS + NUM_SAMPLES * INTERVAL_MS          # bench variant 0
    shift = SERVE_SCALE_SHIFT * STEP_MS
    R0, R1, R2 = (s0, e0), (s0 + shift, e0 + shift), \
        (s0 + 2 * shift, e0 + 2 * shift)
    ms = engine.memstore
    engines = [QueryEngine(ms, engine.dataset, device=dev,
                           config=QueryConfig(**SERVE_CONFIG))
               for _ in range(SERVE_SCALE_REPS)]
    want = {R: engine.query_range(q, *R, STEP_MS) for R in (R0, R1)}
    times = {k: [] for k in ("cold", "hit", "shift", "ingest+shift",
                             "typo", "typo hit")}
    launches = {k: [] for k in times}
    bit_equal = {k: True for k in times}
    k1_args = {}
    paths = {}

    def step(name, eng, R, oracle=None, query=q):
        reset_k1(fg)
        seen = []
        with k1_launch_args(fg, seen):
            ms_, r = serve_time(torch, np, lambda: eng.query_range(
                query, *R, STEP_MS))
        times[name].append(ms_)
        launches[name].append(fg.fused_grid_kernel.launches)
        k1_args.setdefault(name, seen)
        paths.setdefault(name, r.exec_path)
        if oracle is not None:
            bit_equal[name] &= serve_check(np, name, r, oracle)
        return r

    for eng in engines:
        step("cold", eng, R0, want[R0])
        step("hit", eng, R0, want[R0])
        r = step("shift", eng, R1, want[R1])
    assert paths["cold"] == "local" and paths["hit"] == "result-cache[local]"
    assert paths["shift"] == f"incremental[reused={47 - 4},computed=4]", \
        paths["shift"]
    assert launches["cold"] == launches["shift"] == [1] * SERVE_SCALE_REPS \
        and launches["hit"] == [0] * SERVE_SCALE_REPS, launches
    reused_shift = r.stats.fragment_steps_reused
    # the admission gate's estimate: one index selection under the lock
    plan = promql.query_to_logical_plan(q, *R0, STEP_MS)
    cost_ms = []
    for _ in range(SERVE_SCALE_REPS):
        t0 = time.perf_counter()
        cost = engines[0].estimate_cost(plan)
        cost_ms.append((time.perf_counter() - t0) * 1000)
    assert cost == NUM_SERIES * 47 * 2.0, cost
    ingest_s, min_ts = serve_ingest_scale(np, shard)
    want[R2] = engine.query_range(q, *R2, STEP_MS)
    for eng in engines:
        r = step("ingest+shift", eng, R2, want[R2])
    tail = (R2[1] - min_ts) // STEP_MS + 1
    assert paths["ingest+shift"] == \
        f"incremental[reused={47 - tail},computed={tail}]", \
        paths["ingest+shift"]
    assert launches["ingest+shift"] == [1] * SERVE_SCALE_REPS, launches
    reused_ingest = r.stats.fragment_steps_reused
    typo = "sum(rate(typo_metric[5m]))"
    for eng in engines:
        step("typo", eng, R0, query=typo)
        r = step("typo hit", eng, R0, query=typo)
        assert r.exec_path == "negative-cache" and r.matrix.num_series == 0
    assert launches["typo"] == launches["typo hit"] == \
        [0] * SERVE_SCALE_REPS, launches
    # what a full cache of the phase's queries holds, by device
    dev_b = host_b = 0
    for eng in engines:
        for _epochs, payload in eng.result_cache._entries.values():
            v = payload[0].values
            if isinstance(v, torch.Tensor) and v.is_cuda:
                dev_b += v.numel() * v.element_size()
            else:
                host_b += np.asarray(v).nbytes
    frag_b = engines[0].fragment_cache.stats()["bytes"]
    # one concurrent round of bench's 8 variants, caches on
    variants = [(s0 + k * INTERVAL_MS, e0 - k * INTERVAL_MS)
                for k in range(8)]
    expect = [engine.query_range(q, *v, STEP_MS) for v in variants]
    eng = engines[0]
    rc0, fc0 = eng.result_cache.stats(), eng.fragment_cache.stats()

    def run(i):
        return i, eng.query_range(q, *variants[i % 8], STEP_MS)

    reset_k1(fg)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=64) as pool:
        outs = list(pool.map(run, range(500)))
    round_ms = (time.perf_counter() - t0) * 1000
    round_launches = fg.fused_grid_kernel.launches
    # a variant whose fragment another thread stored is served whole from
    # it, its last steps from a shorter K1 launch: within the bar
    round_bit_equal = sum(serve_check(np, f"round {i}", r, expect[i % 8])
                          for i, r in outs)
    rc1, fc1 = eng.result_cache.stats(), eng.fragment_cache.stats()
    hits = int(rc1["hits"] - rc0["hits"])
    misses = int(rc1["misses"] - rc0["misses"])
    frag_hits = int(fc1["hits"] - fc0["hits"])
    # every result-cache miss executes (one K1 launch) unless its range
    # is served whole from the fragment cache
    assert hits + misses == 500 and round_launches == misses - frag_hits, \
        (hits, misses, frag_hits, round_launches)
    assert eng.admission.stats()["in_use"] == 0.0
    p50 = {k: float(np.percentile(v, 50)) for k, v in times.items()}
    full_args, tail_args = k1_args["cold"][0], k1_args["shift"][0]
    log(f"serving scale [{card}]: {NUM_SERIES} series, {q} over bench "
        f"variant 0 (47 steps), every cache and admission on; p50 over "
        f"{SERVE_SCALE_REPS} engines (host ms): cold {p50['cold']:.3f} (K1 "
        f"launches {launches['cold']}), result-cache hit {p50['hit']:.3f} "
        f"(K1 {launches['hit']}), shift by {SERVE_SCALE_SHIFT} steps "
        f"{p50['shift']:.3f} ({paths['shift']}, K1 {launches['shift']}, "
        f"fragment_steps_reused {reused_shift}), a new sample for every "
        f"series ingested and flushed in {ingest_s:.3f} s, then the range "
        f"shifted {SERVE_SCALE_SHIFT} more {p50['ingest+shift']:.3f} "
        f"({paths['ingest+shift']}, K1 {launches['ingest+shift']}, "
        f"fragment_steps_reused {reused_ingest}), a typo'd metric "
        f"{p50['typo']:.3f} then a negative hit {p50['typo hit']:.3f} (K1 "
        f"{launches['typo']}, {launches['typo hit']})")
    log(f"serving scale [{card}]: each engine's host ms "
        f"{ {k: [round(x, 3) for x in v] for k, v in times.items()} }")
    log(f"serving scale [{card}]: K1 (Tp, active columns, G) full "
        f"{full_args} -> launch shape {fg.k1_launch_shape(NUM_SERIES, full_args[1], full_args[0], full_args[2], 2)}; "
        f"tail of {SERVE_SCALE_SHIFT} steps {tail_args} -> "
        f"{fg.k1_launch_shape(NUM_SERIES, tail_args[1], tail_args[0], tail_args[2], 2)}; "
        f"after the ingest {k1_args['ingest+shift'][0]}; answers against "
        f"the caches-off engine: bit-equal {bit_equal} (else within rtol "
        f"1e-5)")
    log(f"serving scale [{card}]: estimate_cost {cost:.0f} in "
        f"{np.percentile(cost_ms, 50):.3f} ms (p50 of {SERVE_SCALE_REPS}: "
        f"a selection of {NUM_SERIES} series under the shard lock); "
        f"result caches of the {SERVE_SCALE_REPS} engines hold "
        f"{dev_b} device bytes and {host_b} host bytes, a fragment cache "
        f"{frag_b} host bytes; one concurrent round of 500 queries over "
        f"bench's 8 variants from 64 threads: {round_ms / 500:.3f} ms a "
        f"query, {hits} result-cache hits, {misses} misses, {frag_hits} "
        f"served whole by the fragment cache, K1 launches {round_launches}; "
        f"{round_bit_equal} of 500 answers bit-equal to the caches-off "
        f"engine's, the rest within rtol 1e-5")
    return sum(sum(v) for v in launches.values()) + round_launches



# ---- phase 13: the durable tier and the retention tiers --------------------

# a base on the 10-minute grid, so 1m, 5m and 10m downsample buckets start
# with the data
DUR_BASE = 1_699_999_800_000
DUR_IV = 10_000
M1_MS, M5_MS, M10_MS = 60_000, 300_000, 600_000

# 13a: 32 counters "m" (4 stop at cell 60: purge fodder) and 16 gauges "g",
# 180 cells; 9 containers of 20 cells, the first 6 persisted; a histogram
# dataset of 16 series x B = 8 beside them
DUR_SMALL_CELLS = 180
DUR_SMALL_BATCH = 20
DUR_SMALL_PERSIST = 5          # containers 0..5 reach the sink
DUR_SMALL_STALE = (3, 10, 17, 24)
DUR_SMALL_ODP_BATCH = 16
DUR_SMALL_RANGE = (DUR_BASE + 300_000, DUR_BASE + 1_790_000, 30_000)
DUR_SMALL_QUERIES = ("sum(rate(m[5m]))", "sum by (dc) (increase(m[5m]))",
                     "avg(avg_over_time(g[5m]))", "max_over_time(g[2m])")
DUR_HIST_QUERY = "histogram_quantile(0.9, sum(rate(lat[5m])))"
DUR_HIST_LES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, float("inf"))

# 13b: one phase-11b mesh shard's shape, exact counters, f32 on the card
DUR_SERIES = 1 << 17
DUR_CELLS = 720
DUR_CONTAINERS = 6             # 120 cells each
DUR_PERSISTED = 4              # containers 0..3 (2/3) reach the sink
DUR_GROUPS = 16
DUR_NARROW_SEL = 'sum(rate(m{grp="g7"}[5m]))'      # 4096 series: 1 batch
# 8192 series, 2 batches: half the 16384 (4 batches) first planned, since
# phase 13b runs far past its 60 s target on host work
DUR_WIDE_SEL = 'sum(rate(m{blk="b3"}[5m]))'
DUR_QUERY = "sum(rate(m[5m]))"
DUR_ROUTED = "sum(avg_over_time(m[30m]))"


def dur_small_data(np):
    """Labels and [48, 180] values of phase 13a: integer counters (delta8
    rows: an anchor below 2^20 plus increments in [0, 8]) and integer
    gauges (steps in [-5, 5]); the stale series stop at cell 60."""
    rng = np.random.default_rng(13)
    labels, vals, ncell = [], [], []
    for i in range(48):
        name = "m" if i < 32 else "g"
        labels.append({"_metric_": name, "host": f"h{i}", "dc": f"dc{i % 3}"})
        if name == "m":
            v = float(rng.integers(0, 1 << 20)) + np.cumsum(
                rng.integers(0, 9, DUR_SMALL_CELLS))
        else:
            v = 5000.0 + np.cumsum(rng.integers(-5, 6, DUR_SMALL_CELLS))
        vals.append(v.astype(np.float64))
        ncell.append(60 if i in DUR_SMALL_STALE else DUR_SMALL_CELLS)
    hrng = np.random.default_rng(14)
    inc = hrng.integers(0, 3, (16, DUR_SMALL_CELLS, len(DUR_HIST_LES)))
    hist = np.cumsum(np.cumsum(inc, axis=2), axis=1).astype(np.float64)
    return labels, np.stack(vals), ncell, hist


def dur_small_containers(np, RecordBuilder, GAUGE, PROM_HISTOGRAM, data, k):
    """Container ``k`` of the gauge dataset and of the histogram one."""
    labels, vals, ncell, hist = data
    lo, hi = k * DUR_SMALL_BATCH, (k + 1) * DUR_SMALL_BATCH
    ts = DUR_BASE + np.arange(lo, hi, dtype=np.int64) * DUR_IV
    b = RecordBuilder(GAUGE)
    for i, lbl in enumerate(labels):
        if ncell[i] > lo:
            top = min(hi, ncell[i])
            b.add_batch(lbl, ts[:top - lo], vals[i, lo:top])
    hb = RecordBuilder(PROM_HISTOGRAM,
                       bucket_les=np.asarray(DUR_HIST_LES, np.float64))
    for s in range(hist.shape[0]):
        h = hist[s, lo:hi]
        hb.add_batch({"_metric_": "lat", "pod": f"p{s}"}, ts,
                     {"sum": h[:, -1] * 3.0, "count": h[:, -1], "h": h})
    return b.build(), hb.build()


def dur_answer(np, r) -> dict:
    m = r.matrix.to_host()
    return {"path": re.sub(r"\[(cuda|plain)\]", "", r.exec_path),
            "full_path": r.exec_path,
            "stats": {f: getattr(r.stats, f) for f in r.stats.FIELDS},
            "resolution": r.stats.resolution,
            "keys": [k.labels for k in m.keys], "ts": np.asarray(m.out_ts),
            "les": (None if m.bucket_les is None
                    else np.asarray(m.bucket_les).tolist()),
            "vals": np.asarray(m.values, np.float64)[:len(m.keys)]}


def dur_tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(root) for f in files)


def dur_tree(root: str) -> dict:
    """relative path -> bytes of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def dur_state(np, sh) -> dict:
    """A shard's index, rows and visibility state, on the host."""
    idx = [(p, sh.index.labels_of(p), sh.index.start_time(p),
            sh.index.end_time(p)) for p in range(len(sh.index))]
    rows = []
    if sh.store is not None:
        t, v = sh.store.snapshot_arrays()
        t, v = t.cpu().numpy(), v.cpu().numpy()
        for p in range(len(sh.index)):
            n = int(sh.store.n_host[p])
            rows.append((t[p, :n].tolist(), v[p, :n].tolist()))
    return {"index": idx, "rows": rows, "epochs": sh.epoch_state(),
            "visible_lead": sh.visible_lead_ms, "lead": sh.lead_ms,
            "watermarks": sh.group_watermarks.tolist()}


def dur_small_run(np, fg, fr, pkg, dev, root):
    """Phase 13a's eight steps on one device; returns what the card and
    the CPU must agree on, and each step's K1 / K2 launches."""
    from filodb_tpu_torch.core.downsample import InlineDownsampler, ds_family
    from filodb_tpu_torch.core.filters import Equals
    from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM, Schemas
    from filodb_tpu_torch.core.store import CODEC_BACKEND, FileColumnStore
    from filodb_tpu_torch.ingest.bus import FileBus
    from filodb_tpu_torch.jobs.batch_downsampler import (
        load_downsampled, make_inline_publisher, run_batch_downsample,
        run_cascade_downsample)
    from filodb_tpu_torch.query import exec as qexec
    from filodb_tpu_torch.query.retention import (RetentionPolicy,
                                                  RetentionRouter)
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    out, k1, k2 = {"codec": CODEC_BACKEND}, {}, {}
    sink_dir, bus_p, bus_h = (os.path.join(root, "sink"),
                              os.path.join(root, "bus", "p.log"),
                              os.path.join(root, "bus", "h.log"))

    def cfg(residency="off", series=64):
        return StoreConfig(max_series_per_shard=series,
                           samples_per_series=256, flush_batch_size=10**9,
                           groups_per_shard=4, compressed_residency=residency,
                           device=dev)

    def query(eng, what, q, rng=DUR_SMALL_RANGE, **kw):
        reset_k1(fg)
        fr.fused_hist_kernel.launches = 0
        r = eng.query_range(q, *rng, **kw)
        out[what] = dur_answer(np, r)
        k1[what] = fg.fused_grid_kernel.launches
        k2[what] = fr.fused_hist_kernel.launches
        for kind, n in fg.fused_grid_kernel.launches_by_kind.items():
            if n and kind != "raw":
                k1[f"{what} [{kind}]"] = n
        return r

    # 1. ingest with offsets, persist part, crash
    data = dur_small_data(np)
    sink, bus, hbus = (FileColumnStore(sink_dir), FileBus(bus_p),
                       FileBus(bus_h))
    ms = TimeSeriesMemStore(device=dev)
    sh = ms.setup("p", GAUGE, 0, cfg(), sink=sink)
    sh.downsample = (M1_MS, InlineDownsampler(
        M1_MS, make_inline_publisher(sink, "p", M1_MS)))
    hsh = ms.setup("h", PROM_HISTOGRAM, 0, cfg(series=16), sink=sink)
    for k in range(DUR_SMALL_CELLS // DUR_SMALL_BATCH):
        c, hc = dur_small_containers(np, RecordBuilder, GAUGE,
                                     PROM_HISTOGRAM, data, k)
        sh.ingest(c, bus.publish(c))
        hsh.ingest(hc, hbus.publish(hc))
        sh.flush()
        hsh.flush()
        if k == DUR_SMALL_PERSIST:
            sh.flush_all_groups()
            hsh.flush_all_groups()
    pre = QueryEngine(ms, "p", device=dev)
    for q in DUR_SMALL_QUERIES:
        query(pre, f"pre-crash {q}", q)
    del ms, sh, hsh, pre

    # 2. recover from the sink and the bus
    sink2 = FileColumnStore(sink_dir)
    ms2 = TimeSeriesMemStore(device=dev)
    sh2 = ms2.setup("p", GAUGE, 0, cfg(), sink=sink2)
    floor = sink2.read_meta(ds_family("p", M1_MS), 0)["published_through"]
    inline = InlineDownsampler(M1_MS, make_inline_publisher(sink2, "p",
                                                            M1_MS),
                               floor_ms=floor)
    sh2.downsample = (M1_MS, inline)
    out["replayed"] = sh2.recover(FileBus(bus_p), Schemas(),
                                  on_chunks_loaded=lambda: inline
                                  .seed_from_store(sh2))
    assert out["replayed"] == sum(
        min(n, DUR_SMALL_CELLS) - min(n, (DUR_SMALL_PERSIST + 1)
                                      * DUR_SMALL_BATCH)
        for n in data[2]), out["replayed"]
    out["recovered"] = dur_state(np, sh2)
    eng2 = QueryEngine(ms2, "p", device=dev)
    for q in DUR_SMALL_QUERIES:
        query(eng2, f"recovered {q}", q)

    # 3. a histogram shard recovered into "all": K2 over its 2D-delta block
    hms = TimeSeriesMemStore(device=dev)
    hsh2 = hms.setup("h", PROM_HISTOGRAM, 0, cfg("all", 16), sink=sink2)
    hsh2.recover(FileBus(bus_h), Schemas())
    assert hsh2.store.is_narrow_resident
    out["hist recovered"] = dur_state(np, hsh2)["index"]
    query(QueryEngine(hms, "h", device=dev), "hist K2", DUR_HIST_QUERY)

    # 4. the gauge dataset recovered into a "gauge" shard: K1-delta8
    gms = TimeSeriesMemStore(device=dev)
    gsh = gms.setup("p", GAUGE, 0, cfg("gauge"), sink=sink2)
    gsh.recover(FileBus(bus_p), Schemas())
    nd = gsh.store.narrow_operands()
    assert nd is not None and nd[0] == "delta8" and nd[2][:48].all(), \
        nd and nd[0]
    query(QueryEngine(gms, "p", device=dev), "delta8 sum(rate)",
          "sum(rate(m[5m]))")
    out["delta8 vs decode"] = dur_delta8_vs_decode(np, fg, gsh)

    # 5. compact, then cold ranges through the narrow and the wide ODP path
    with sh2.lock:
        sh2.store.compact(DUR_BASE + 50 * DUR_IV)
    saved, qexec.ODP_BATCH = qexec.ODP_BATCH, DUR_SMALL_ODP_BATCH
    try:
        query(eng2, "odp narrow", 'sum(rate(m{dc="dc0"}[5m]))')
        query(eng2, "odp wide", "sum by (dc) (rate(m[5m]))")
        query(eng2, "odp wide per-series", "max_over_time(m[10m])")
    finally:
        qexec.ODP_BATCH = saved
    assert out["odp narrow"]["stats"]["rows_paged_in"] == 11
    assert out["odp wide"]["stats"]["rows_paged_in"] == 32
    out["odp raw_series"] = [
        (lbl, t.tolist(), v.tolist()) for lbl, t, v in eng2.raw_series(
            [Equals("dc", "dc1")], DUR_BASE, DUR_BASE + 10**7)]
    assert len(out["odp raw_series"][0][1]) == DUR_SMALL_CELLS

    # 6. purge, then the durable age-out
    e0 = sh2.data_epoch
    out["purged"] = sh2.purge_expired_partitions(DUR_BASE + 100 * DUR_IV)
    assert out["purged"] == len(DUR_SMALL_STALE), out["purged"]
    out["purge epochs"] = sh2.epoch_state()[1][-(sh2.data_epoch - e0):]
    sh2.flush_all_groups()
    e1 = sh2.data_epoch
    out["aged out"] = sh2.age_out_durable(DUR_BASE + 60 * DUR_IV)
    assert out["aged out"] > 0 and sh2.data_epoch == e1 + 1, (out["aged out"], sh2.data_epoch, e1)
    out["age-out epoch"] = sh2.epoch_state()[1][-1]

    # 7. the inline family at flush, then the batch and cascade jobs
    inline.flush_remaining(sh2)
    out["batch 5m"] = run_batch_downsample(sink2, "p", 0, M5_MS)
    out["cascade 1m->10m"] = run_cascade_downsample(sink2, "p", 0, M1_MS,
                                                    M10_MS)
    out["sink files"] = {k: v for k, v in dur_tree(sink_dir).items()
                         if not k.endswith(".tmp")}

    # 8. load the families, __col__, routed and stitched resolution queries
    fams = {}
    for res in (M1_MS, M5_MS):
        fms = TimeSeriesMemStore(device=dev)
        load_downsampled(sink2, "p", 0, res, "dAvg", fms)
        fams[res] = QueryEngine(fms, ds_family("p", res), device=dev)
    query(fams[M1_MS], "family __col__", 'max(m{__col__="dMax"})')
    query(fams[M5_MS], "family ::dAvg", 'm::dAvg{host="h1"}',
          (DUR_BASE + 600_000, DUR_BASE + 1_790_000, M5_MS))
    eng2.retention = RetentionRouter(
        RetentionPolicy([M1_MS, M5_MS], raw_window_ms=10 * M1_MS),
        fams.get, dataset="p")
    lead = DUR_BASE + (DUR_SMALL_CELLS - 1) * DUR_IV
    query(eng2, "routed stitched", "sum(avg_over_time(m[5m]))",
          (DUR_BASE + 600_000, lead, M1_MS))
    assert out["routed stitched"]["resolution"] == "1m+raw"
    query(eng2, "resolution=5m", "sum(avg_over_time(m[10m]))",
          (DUR_BASE + 600_000, DUR_BASE + 1_500_000, M5_MS),
          resolution="5m")
    assert out["resolution=5m"]["full_path"].startswith("retention[5m]:")
    return out, k1, k2


def dur_delta8_vs_decode(np, fg, sh) -> bool:
    """K1 on a recovered shard's delta8 block against K1 raw on its decode,
    bit for bit (True when they agree; the CPU has no K1 to hold)."""
    import torch
    from filodb_tpu_torch.ops import decodereg
    st = sh.store
    if st.device.type != "cuda":
        return True
    kind, ops, ok = st.narrow_operands()
    n = torch.where(torch.from_numpy(ok).to(st.device), st.n, 0).contiguous()
    gids = fg.zero_gids(st.S, st.device)
    s, e, step = DUR_SMALL_RANGE
    out_ts = np.arange(s, e + 1, step, dtype=np.int64) - DUR_BASE
    Tp = -(-len(out_ts) // 128) * 128
    _b, _o, lo, hi, rel, c0, Ca = fg.device_operands(
        st.C, Tp, out_ts.tobytes(), WINDOW_MS, 0, DUR_IV, "rate",
        decodereg.variant(kind).full_columns, st.device)
    a = fg.fused_grid_kernel("rate", True, WINDOW_MS, DUR_IV, ops[0], n,
                             gids, lo, hi, rel, 8, c0, Ca, kind, ops[1:])
    b = fg.fused_grid_kernel("rate", True, WINDOW_MS, DUR_IV,
                             st.value_block(), n, gids, lo, hi, rel, 8, c0,
                             Ca)
    return same_outputs(a, b)


def phase_durable_small(torch, np, fg, fr, pkg, devs=("cuda", "cpu")):
    """Phase 13a: the eight steps on the card against the CPU, each in its
    own temporary directory: the same index, rows, epochs, routes,
    QueryStats (rows_paged_in, resolution), counts and sink files, the
    answers within rtol 1e-5 of the largest magnitude. Returns (K1
    launches by step, K2 launches by step, steps compared, codec)."""
    import tempfile
    runs = {}
    with tempfile.TemporaryDirectory(prefix="filodb-durable-") as tmp:
        for i, dev in enumerate(devs):
            runs[i] = dur_small_run(np, fg, fr, pkg, dev,
                                    os.path.join(tmp, f"{i}-{dev}"))
    (card, k1, k2), (cpu, _k1c, _k2c) = runs[0], runs[1]
    assert set(card) == set(cpu)
    n = 0
    for what, g in card.items():
        r = cpu[what]
        if isinstance(g, dict) and "vals" in g:
            for k in ("path", "stats", "resolution", "keys", "les"):
                assert g[k] == r[k], (what, k, g[k], r[k])
            assert np.array_equal(g["ts"], r["ts"]), what
            assert (np.isnan(g["vals"]) == np.isnan(r["vals"])).all(), what
            scale = float(np.nanmax(np.abs(r["vals"]), initial=0.0))
            tol = 1e-3 if what == "hist K2" else 1e-5
            np.testing.assert_allclose(g["vals"], r["vals"], rtol=tol,
                                       atol=tol * scale, equal_nan=True,
                                       err_msg=what)
            assert np.isfinite(g["vals"]).any(), what
        elif what == "sink files":
            assert sorted(g) == sorted(r), (sorted(g), sorted(r))
            for f in g:
                assert g[f] == r[f], f
        else:
            assert g == r, (what, g if not isinstance(g, dict) else "...")
        n += 1
    assert card["delta8 vs decode"] is True
    # the recovered answers are the pre-crash ones: the same rows, the
    # same route
    for q in DUR_SMALL_QUERIES:
        a, b = card[f"pre-crash {q}"], card[f"recovered {q}"]
        assert a["full_path"] == b["full_path"], q
        assert np.array_equal(a["vals"], b["vals"], equal_nan=True), q
    if devs[0] == "cuda":
        fused = {w: g["stats"]["fused_kernels"] for w, g in card.items()
                 if isinstance(g, dict) and "stats" in g}
        assert all(k1[w] + k2[w] == fused[w] for w in fused), (k1, k2, fused)
        assert k2["hist K2"] == 1 and k1["delta8 sum(rate) [delta8]"] == 1
        assert card["hist K2"]["full_path"] == "fused-hist-narrow[cuda]"
    return k1, k2, n, card["codec"]


def dur_scale_data(np, S, k, prev):
    """Container ``k``'s [S, cells] values of phase 13b's exact counters,
    continuing the rows' last values ``prev`` (None: draw the anchors):
    anchors below 2^20 plus increments in [0, 8] from seeded generators
    (every value below 2^23: exact in f32)."""
    per = DUR_CELLS // DUR_CONTAINERS
    if prev is None:
        prev = np.random.default_rng(1300).integers(
            0, 1 << 20, S).astype(np.float64)
    inc = np.random.default_rng(1301 + k).integers(0, 9, (S, per))
    return prev[:, None] + np.cumsum(inc, axis=1)


def dur_scale_container(np, builder, S, k, vals):
    """Container ``k`` (cells [120k, 120k + 120) of every series) through
    the real RecordBuilder: one add_batch a series."""
    per = DUR_CELLS // DUR_CONTAINERS
    ts = DUR_BASE + np.arange(k * per, (k + 1) * per, dtype=np.int64) * DUR_IV
    for i in range(S):
        builder.add_batch({"_metric_": "m", "host": f"h{i}",
                           "grp": f"g{i % 32}", "blk": f"b{i % 16}"},
                          ts, vals[i])
    return builder.build()


def dur_capture(publish, captured: list):
    """The inline publisher ``publish`` that also keeps a host copy of the
    dAvg records it hands to the sink (the oracle's input)."""
    import numpy as np

    def wrapped(shard, recs):
        publish(shard, recs)
        p, t, v = recs["dAvg"]
        captured.append((np.array(p, np.int64), np.array(t), np.array(v)))
    wrapped.published_max = publish.published_max
    return wrapped


def dur_family_oracle(np, captured, out_ts, window_ms):
    """sum(avg_over_time(m::dAvg[w])) from the published records on the
    host, in f64: keep-first on (pid, bucket) as the loader dedups, then per
    series the mean of its bucket averages with timestamps in [t - w, t],
    summed over the series that have one."""
    p = np.concatenate([c[0] for c in captured])
    t = np.concatenate([c[1] for c in captured])
    v = np.concatenate([c[2] for c in captured])
    key = p << 42 | (t % (1 << 42))
    _u, idx = np.unique(key, return_index=True)
    idx.sort()
    p, t, v = p[idx], t[idx], v[idx]
    n_pid = int(p.max()) + 1
    out = np.full(len(out_ts), np.nan)
    for j, te in enumerate(out_ts):
        sel = (t >= te - window_ms) & (t <= te)
        if not sel.any():
            continue
        s = np.bincount(p[sel], weights=v[sel], minlength=n_pid)
        c = np.bincount(p[sel], minlength=n_pid)
        out[j] = float((s[c > 0] / c[c > 0]).sum())
    return out


def phase_durable_scale(torch, np, fg, card, pkg, dev="cuda", S=DUR_SERIES,
                        wide_sel=DUR_WIDE_SEL):
    """Phase 13b: a restart of one 2^17 x 720 shard. Returns K1's launches
    on the phase's main path (recovered shard and downsample family)."""
    import tempfile
    from filodb_tpu_torch.core.downsample import InlineDownsampler, ds_family
    from filodb_tpu_torch.core.schemas import Schemas
    from filodb_tpu_torch.core.store import CODEC_BACKEND, FileColumnStore
    from filodb_tpu_torch.ingest.bus import FileBus
    from filodb_tpu_torch.jobs.batch_downsampler import (load_downsampled,
                                                         make_inline_publisher)
    from filodb_tpu_torch.query.retention import (RetentionPolicy,
                                                  RetentionRouter)
    from filodb_tpu_torch.utils.metrics import (FILODB_INDEX_RECOVER_MS,
                                                registry)
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    def cfg():
        return StoreConfig(max_series_per_shard=S, samples_per_series=CAPACITY,
                           flush_batch_size=10**9, groups_per_shard=DUR_GROUPS,
                           device=dev)

    def run(eng, q, rng, reps=1, **kw):
        """(answer, route, QueryStats, p50 host ms over ``reps``)."""
        times, r = [], None
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            r = eng.query_range(q, *rng, **kw)
            vals = np.asarray(r.matrix.to_host().values, np.float64)
            times.append((time.perf_counter() - t0) * 1000)
        return vals, r.exec_path, r.stats, float(np.percentile(times, 50))

    lead = DUR_BASE + (DUR_CELLS - 1) * DUR_IV
    full = (DUR_BASE + WINDOW_MS, lead, STEP_MS)
    k1 = 0
    with tempfile.TemporaryDirectory(prefix="filodb-restart-") as tmp:
        sink_dir = os.path.join(tmp, "sink")
        bus_path = os.path.join(tmp, "bus", "dur.log")
        # 1. ingest with offsets, persist the first 2/3, crash
        sink, bus = FileColumnStore(sink_dir), FileBus(bus_path)
        ms = TimeSeriesMemStore(device=dev)
        sh = ms.setup("dur", GAUGE, 0, cfg(), sink=sink)
        captured: list = []
        sh.downsample = (M5_MS, InlineDownsampler(M5_MS, dur_capture(
            make_inline_publisher(sink, "dur", M5_MS), captured)))
        builder = RecordBuilder(GAUGE)
        t_gen = t_ingest = flush_s = 0.0
        vals = None
        for k in range(DUR_CONTAINERS):
            t0 = time.perf_counter()
            vals = dur_scale_data(np, S, k, None if vals is None
                                  else vals[:, -1])
            c = dur_scale_container(np, builder, S, k, vals)
            off = bus.publish(c)
            t_gen += time.perf_counter() - t0
            t0 = time.perf_counter()
            sh.ingest(c, off)
            sh.flush()
            sync()
            t_ingest += time.perf_counter() - t0
            del c
            if k == DUR_PERSISTED - 1:
                t0 = time.perf_counter()
                sh.flush_all_groups()
                flush_s = time.perf_counter() - t0
                log_bytes = os.path.getsize(os.path.join(
                    sink_dir, "dur", "shard0", "chunks.log"))
        bus_bytes = os.path.getsize(bus_path)
        # 2. the reference answers, through K1, before the crash
        eng = QueryEngine(ms, "dur", device=dev)
        pre = {q: run(eng, q, full) for q in (DUR_QUERY, DUR_NARROW_SEL,
                                              wide_sel)}
        for q, (_v, path, st, _ms) in pre.items():
            assert path == "local" and st.fused_kernels == 1, (q, path)
        del eng, sh, ms
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

        # 3. a fresh memstore recovers from the sink and the bus
        sink2 = FileColumnStore(sink_dir)
        ms2 = TimeSeriesMemStore(device=dev)
        sh2 = ms2.setup("dur", GAUGE, 0, cfg(), sink=sink2)
        family = ds_family("dur", M5_MS)
        inline = InlineDownsampler(
            M5_MS, dur_capture(make_inline_publisher(sink2, "dur", M5_MS),
                               captured),
            floor_ms=sink2.read_meta(family, 0)["published_through"])
        sh2.downsample = (M5_MS, inline)
        marks = {}

        def loaded():
            sync()
            marks["chunks"] = time.perf_counter()
            inline.seed_from_store(sh2)
            marks["seeded"] = time.perf_counter()

        t0 = time.perf_counter()
        replayed = sh2.recover(FileBus(bus_path), Schemas(),
                               on_chunks_loaded=loaded)
        sync()
        t_end = time.perf_counter()
        index_ms = registry.gauge(FILODB_INDEX_RECOVER_MS,
                                  {"dataset": "dur", "shard": "0"}).value
        chunks_s = marks["chunks"] - t0 - index_ms / 1000
        seed_s = marks["seeded"] - marks["chunks"]
        replay_s = t_end - marks["seeded"]
        assert sh2.num_series == S and replayed == S * (
            DUR_CELLS - DUR_PERSISTED * DUR_CELLS // DUR_CONTAINERS), replayed

        # 4. the recovered shard through K1: bit-equal to the pre-crash answer
        eng2 = QueryEngine(ms2, "dur", device=dev)
        reset_k1(fg)
        post = {q: run(eng2, q, full, reps=3) for q in pre}
        raw_routed = run(eng2, DUR_ROUTED, (DUR_BASE + 30 * M1_MS, lead,
                                            M5_MS), reps=3)
        k1 += fg.fused_grid_kernel.launches
        on_card = torch.device(dev).type == "cuda"
        assert fg.fused_grid_kernel.launches == (3 * 3 + 3) * on_card, \
            fg.fused_grid_kernel.launches
        bit_equal = {}
        for q in pre:
            assert post[q][1] == "local" and post[q][2].fused_kernels == 1
            bit_equal[q] = bool(np.array_equal(pre[q][0], post[q][0],
                                               equal_nan=True))
            np.testing.assert_allclose(post[q][0], pre[q][0], rtol=1e-5,
                                       err_msg=q)

        # 5. compact away the oldest 2/3; cold queries page them back in
        with sh2.lock:
            sh2.store.compact(DUR_BASE + DUR_PERSISTED * DUR_CELLS
                              // DUR_CONTAINERS * DUR_IV)
        cold = {q: run(eng2, q, full) for q in (DUR_NARROW_SEL, wide_sel)}
        for q, (vals, path, st, _ms) in cold.items():
            assert path == "local" and st.fused_kernels == 0, (q, path)
            np.testing.assert_allclose(vals, pre[q][0], rtol=1e-5,
                                       err_msg=f"cold {q}")
        n_narrow = cold[DUR_NARROW_SEL][2].rows_paged_in
        n_wide = cold[wide_sel][2].rows_paged_in
        assert n_narrow == S // 32 and n_wide == S // 16, (n_narrow, n_wide)
        # 6. the node persists the replayed third; the inline downsampler,
        # seeded from the loaded chunks, closes every bucket
        t0 = time.perf_counter()
        sh2.flush_all_groups()
        inline.flush_remaining(sh2)
        flush2_s = time.perf_counter() - t0

        # the 5m family the inline downsampler published, loaded and
        # queried through the router with resolution="5m"
        t0 = time.perf_counter()
        fms = TimeSeriesMemStore(device=dev)
        fam_sh = load_downsampled(sink2, "dur", 0, M5_MS, "dAvg", fms)
        load_s = time.perf_counter() - t0
        assert int(fam_sh.store.n_host[:S].min()) == \
            int(fam_sh.store.n_host[:S].max()) == DUR_CELLS * DUR_IV // M5_MS
        assert fam_sh.store.grid_info() is not None
        fam = QueryEngine(fms, family, device=dev)
        eng2.retention = RetentionRouter(
            RetentionPolicy([M5_MS], raw_window_ms=30 * M1_MS),
            {M5_MS: fam}.get, dataset="dur")
        rrange = (DUR_BASE + 30 * M1_MS, lead, M5_MS)
        reset_k1(fg)
        routed = run(eng2, DUR_ROUTED, rrange, reps=3, resolution="5m")
        routed_k1 = fg.fused_grid_kernel.launches
        k1 += routed_k1
        assert routed[1] == "retention[5m]:local", routed[1]
        assert routed[2].resolution == "5m" and routed[2].fused_kernels == 1
        assert routed_k1 == 3 * on_card, routed_k1
        out_ts = np.arange(rrange[0], rrange[1] + 1, M5_MS, dtype=np.int64)
        want = dur_family_oracle(np, captured, out_ts, 30 * M1_MS)
        np.testing.assert_allclose(routed[0][0], want, rtol=1e-5,
                                   err_msg="routed family query vs oracle")

        disk = dur_tree_bytes(tmp)
        free = shutil.disk_usage(tmp).free
    samples = S * DUR_CELLS
    tag = f"durable scale [{card}]"
    log(f"{tag}: {S} series x {DUR_CELLS} samples in {DUR_CONTAINERS} "
        f"RecordBuilder containers published to a FileBus "
        f"({bus_bytes / 1e9:.3f} GB, {t_gen:.1f} s with generation) and "
        f"ingested with offsets ({t_ingest:.1f} s); codec {CODEC_BACKEND}")
    log(f"{tag}: flush_all_groups of the first {DUR_PERSISTED}/"
        f"{DUR_CONTAINERS} ({DUR_GROUPS} groups, inline 5m downsampler on) "
        f"{flush_s:.3f} s; chunk log {log_bytes} B = "
        f"{log_bytes / (S * DUR_PERSISTED * DUR_CELLS // DUR_CONTAINERS):.3f}"
        f" B a sample on disk")
    log(f"{tag}: recovery: index {index_ms:.1f} ms (filodb_index_recover_ms)"
        f", chunk load {chunks_s:.3f} s, downsampler seed {seed_s:.3f} s, "
        f"replay {replay_s:.3f} s of {replayed} rows; the recovered "
        f"shard's answers bit-equal to the pre-crash ones: {bit_equal}")
    log(f"{tag}: resident p50 (3) {post[DUR_NARROW_SEL][3]:.3f} ms over "
        f"{S // 32} series, {post[wide_sel][3]:.3f} ms over {S // 16}; cold "
        f"(ODP) {cold[DUR_NARROW_SEL][3]:.3f} ms narrow ({n_narrow} series "
        f"paged, {n_narrow / cold[DUR_NARROW_SEL][3] * 1000:.0f} series/s), "
        f"{cold[wide_sel][3]:.3f} ms wide ({n_wide} series in "
        f"{-(-n_wide // 4096)} batches, "
        f"{n_wide / cold[wide_sel][3] * 1000:.0f} series/s); within rtol "
        f"1e-5 of the pre-crash answers")
    log(f"{tag}: post-recovery flush_all_groups + the last buckets "
        f"{flush2_s:.3f} s; the 5m family loaded in {load_s:.3f} s; "
        f"{DUR_ROUTED} at 5m with resolution=\"5m\" p50 {routed[3]:.3f} ms "
        f"({routed[1]}, K1 {routed_k1 // 3} a query) against raw "
        f"{raw_routed[3]:.3f} ms ({raw_routed[1]}); within rtol 1e-5 of the "
        f"numpy oracle; {disk / 1e9:.3f} GB on disk at the end "
        f"({free / 1e9:.1f} GB free); {samples} samples")
    return k1


# -- phase 14: the cluster plane ---------------------------------------------

# the reference's two-node fixture (tests/test_remote_exec.py:133-206): 8
# series of two metrics a 2-shard dataset, 120 samples at 10 s
CL_DS = "prometheus"
CL_START = 1_000_000
CL_IV = 10_000
CL_N = 120
CL_RANGE = (CL_START + 600_000, CL_START + 900_000, 30_000)
CL_QUERIES = (
    'sum(rate(m[2m]))', 'sum by (host) (rate(m[2m]))', 'avg by (dc) (m)',
    'max(m)', 'min by (dc) (rate(m[2m]))', 'stddev(m)', 'count(m)',
    'topk(3, m)', 'bottomk(2, rate(m[2m]))', 'quantile(0.5, m)',
    'count_values("v", count(m) by (dc))', 'm + on(host, dc) m2',
    'sum(rate(m[2m])) / sum(rate(m2[2m]))', 'abs(m) * 2',
    'sort_desc(sum by (host) (m))', 'sum(rate(absent_metric[2m]))',
    'm * scalar(sum(m2))', 'clamp_max(rate(m[2m]), 0.5)',
    'm and on(host, dc) m2')
CL_BATCHED = ('sum(rate(m[2m]))', 'avg by (dc) (m)', 'topk(3, m)', 'm')
CL_COLOCATED = ('sum(rate(m[2m]))', 'avg by (dc) (m)', 'topk(3, m)',
                'quantile(0.5, m)', 'm + on(host, dc) m2',
                'sum(avg(max(min(count(m)))))')
# phase 14b: phase 11b's 8 shards of 2^17 split 4/4 over two nodes
CL_SCALE_QUERIES = {"M1": "sum(rate(m[5m]))",
                    "G": "sum by (grp) (rate(m[5m]))",
                    "T": "topk(5, rate(m[5m]))",
                    "Q": "quantile(0.9, rate(m[5m]))"}
CL_SCALE_REPS = {"M1": 3, "G": 1, "T": 3, "Q": 3}
# phase 14c: two node processes of one 2^17 x 720 shard each
CL_PROC_SERIES = 1 << 17
CL_PROC_SEED = 23
CL_PROC_QUERIES = ("sum(rate(m[5m]))", "topk(5, rate(m[5m]))")
CL_PROC_REPS = 3


def cl_answer(np, r) -> dict:
    """Keys in order -> f64 values: what "bit for bit" compares."""
    return {"keys": [k.labels for k in r.matrix.keys],
            "ts": np.asarray(r.matrix.out_ts).tolist(),
            "vals": np.asarray(r.matrix.values, np.float64)}


def cl_same(np, a, b) -> bool:
    return (a["keys"] == b["keys"] and a["ts"] == b["ts"]
            and a["vals"].shape == b["vals"].shape
            and np.array_equal(a["vals"], b["vals"], equal_nan=True))


@contextlib.contextmanager
def k1_by_node(fg, owner):
    """Attribute K1's launches to nodes: ``owner(val)`` names the node a
    launch over ``val`` (the block it streams) belongs to. Yields the
    per-node counter; K1's own counts keep counting underneath."""
    from collections import Counter
    orig = fg.fused_grid_kernel
    per = Counter()

    def shim(fn, needs_sumsq, window_ms, interval_ms, val, *a, **kw):
        per[owner(val)] += 1
        return orig(fn, needs_sumsq, window_ms, interval_ms, val, *a, **kw)

    # the wrapper counts through the module's name: the shim carries the
    # counts while it stands in (the by-kind dict is shared)
    shim.launches = orig.launches
    shim.launches_by_kind = orig.launches_by_kind
    fg.fused_grid_kernel = shim
    try:
        yield per
    finally:
        orig.launches = shim.launches
        fg.fused_grid_kernel = orig


def by_store(nodes: dict):
    """owner(): the node holding the store block a launch streams (wide
    selections stream the shard's own raw or narrow block)."""
    ptrs = {}
    for node, shards in nodes.items():
        for sh in shards:
            if sh.store.val is not None:
                ptrs[sh.store.val.data_ptr()] = node
            nd = sh.store.narrow_operands()
            if nd is not None:
                ptrs[nd[1][0].data_ptr()] = node
    return lambda val: ptrs.get(val.data_ptr(), "?")


def by_thread(state: dict):
    """owner(): in-process nodes queried directly from this thread, whose
    local legs launch here and whose peers' legs launch on the peers'
    HTTP threads: ``state["caller"]`` on this thread, else
    ``state["peer"]``."""
    import threading
    main = threading.current_thread()
    return lambda val: (state["caller"] if threading.current_thread() is main
                        else state["peer"])


@contextlib.contextmanager
def wire_bytes():
    """Bytes on the wire of every cross-node /exec POST (request body +
    response payload) while the block runs."""
    from filodb_tpu_torch.query import wire
    orig = wire._dispatch_post
    tally = {"bytes": 0, "posts": 0}

    def shim(endpoint, dataset, body, timeout_s, shards):
        payload = orig(endpoint, dataset, body, timeout_s, shards)
        tally["bytes"] += len(body) + len(payload)
        tally["posts"] += 1
        return payload

    wire._dispatch_post = shim
    try:
        yield tally
    finally:
        wire._dispatch_post = orig


def cl_populate(np, pkg, dev, shards, nshards):
    """The fixture's memstore holding ``shards`` of an ``nshards`` dataset
    on ``dev``: series i of each metric on shard i % nshards, f32 stores
    on the 10 s grid (K1's route)."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, _qe = pkg
    ms = TimeSeriesMemStore(device=dev)
    for s in shards:
        ms.setup(CL_DS, GAUGE, s, StoreConfig(
            max_series_per_shard=32, samples_per_series=256,
            flush_batch_size=10**9, device=dev))
    ts = CL_START + np.arange(CL_N, dtype=np.int64) * CL_IV
    for i in range(8):
        if i % nshards not in shards:
            continue
        vals = 100.0 * (i + 1) + 10.0 * np.sin(np.arange(CL_N) / 7.0 + i)
        for metric in ("m", "m2"):
            b = RecordBuilder(GAUGE)
            b.add_batch({"_ws_": "demo", "_ns_": "app", "_metric_": metric,
                         "host": f"h{i}", "dc": f"dc{i % 2}"}, ts, vals)
            ms.ingest(CL_DS, i % nshards, b.build())
    ms.flush_all()
    return ms


def cl_cluster(np, pkg, dev, nshards, owner=None):
    """(engines, servers, oracle, manager, endpoints): nodes a and b, each
    a memstore on ``dev`` with its shards of an ``nshards`` dataset and a
    FiloHttpServer; a one-node oracle holding every shard."""
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.parallel.cluster import ShardManager
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    QueryEngine = pkg[4]
    mgr = ShardManager()
    mgr.add_node("a")
    mgr.add_node("b")
    mgr.add_dataset(CL_DS, nshards, claimed=owner)
    owner = {s: mgr.node_of(CL_DS, s) for s in range(nshards)}
    assert set(owner.values()) == {"a", "b"}, owner
    eps: dict = {}
    engines = {n: QueryEngine(
        cl_populate(np, pkg, dev, [s for s in owner if owner[s] == n],
                    nshards), CL_DS, ShardMapper(nshards), device=dev,
        cluster=mgr, node=n, endpoint_resolver=eps.get) for n in "ab"}
    servers = {n: FiloHttpServer({CL_DS: engines[n]}, port=0).start()
               for n in "ab"}
    eps.update({n: f"127.0.0.1:{s.port}" for n, s in servers.items()})
    oracle = QueryEngine(cl_populate(np, pkg, dev, range(nshards), nshards),
                         CL_DS, ShardMapper(nshards), device=dev)
    return engines, servers, oracle, mgr, eps


def cl_two_node(np, fg, pkg, dev) -> tuple:
    """The 19 queries on either node of the two-node fixture on ``dev``,
    each bit for bit the one-node oracle's on ``dev``; the metadata API
    federated. Returns (answers, K1 launches by node)."""
    from filodb_tpu_torch.core import filters as F
    engines, servers, oracle, _mgr, _eps = cl_cluster(np, pkg, dev, 2)
    out = {}
    state = {}
    try:
        with k1_by_node(fg, by_thread(state)) as per:
            for q in CL_QUERIES:
                state.update(caller="oracle", peer="?")
                want = oracle.query_range(q, *CL_RANGE)
                for n in "ab":
                    state.update(caller=n, peer="b" if n == "a" else "a")
                    got = engines[n].query_range(q, *CL_RANGE)
                    assert cl_same(np, cl_answer(np, got),
                                   cl_answer(np, want)), (dev, n, q)
                    assert got.stats.series_matched == \
                        want.stats.series_matched, (dev, n, q)
                    out[(n, q)] = got
        for n in "ab":
            e = engines[n]
            assert e.label_values("host") == oracle.label_values("host")
            assert e.label_names() == oracle.label_names()
            f = [F.Equals("dc", "dc1")]
            assert e.label_values("host", f) == oracle.label_values("host",
                                                                    f)
            key = lambda rows: sorted(tuple(sorted(r.items()))  # noqa: E731
                                      for r in rows)
            sel = [F.Equals("_metric_", "m")]
            assert key(e.series(sel, CL_START, CL_START + CL_N * CL_IV)) == \
                key(oracle.series(sel, CL_START, CL_START + CL_N * CL_IV))
    finally:
        for s in servers.values():
            s.stop()
    return out, dict(per)


def cl_batched_colocated_replan(np, fg, pkg, dev) -> dict:
    """On ``dev``: batched dispatch over a 4-shard dataset (one POST a peer
    a query), the co-located reduce (one POST, the reduce node shipped),
    and replan-once after a peer's server stops; every answer bit for bit
    the one-node oracle's. Returns K1 launches by node."""
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.parallel.cluster import ShardManager
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    from filodb_tpu_torch.promql import parser as promql
    from filodb_tpu_torch.query import wire
    from filodb_tpu_torch.query.exec import ReduceAggregateExec
    QueryEngine = pkg[4]
    launches = {}
    engines, servers, oracle, _mgr, _eps = cl_cluster(np, pkg, dev, 4)
    try:
        want = {q: cl_answer(np, oracle.query_range(q, *CL_RANGE))
                for q in CL_BATCHED}
        with k1_by_node(fg, by_thread({"caller": "a", "peer": "b"})) as per:
            for q in CL_BATCHED:
                before = wire.breakers.total_requests()
                got = engines["a"].query_range(q, *CL_RANGE)
                assert wire.breakers.total_requests() - before == 1, q
                assert cl_same(np, cl_answer(np, got), want[q]), \
                    ("batched", q)
        launches["batched"] = dict(per)
    finally:
        for s in servers.values():
            s.stop()
    # co-located: node c owns nothing, node b both shards
    mgr = ShardManager()
    mgr.add_node("b")
    mgr.add_dataset(CL_DS, 2)
    eng_b = QueryEngine(cl_populate(np, pkg, dev, (0, 1), 2), CL_DS,
                        ShardMapper(2), device=dev, cluster=mgr, node="b")
    srv = FiloHttpServer({CL_DS: eng_b}, port=0).start()
    ep = f"127.0.0.1:{srv.port}"
    eng_c = QueryEngine(pkg[1](device=dev), CL_DS, ShardMapper(2),
                        device=dev, cluster=mgr, node="c",
                        endpoint_resolver=lambda n: ep)
    oracle2 = QueryEngine(cl_populate(np, pkg, dev, (0, 1), 2), CL_DS,
                          ShardMapper(2), device=dev)
    try:
        plan = eng_c.planner.materialize(promql.query_to_logical_plan(
            "sum(rate(m[2m]))", CL_START, CL_START + 60_000, 30_000))
        assert isinstance(plan, wire.RemoteLeafExec) and isinstance(
            plan.inner, ReduceAggregateExec), type(plan)
        want = {q: cl_answer(np, oracle2.query_range(q, *CL_RANGE))
                for q in CL_COLOCATED}
        with k1_by_node(fg, by_thread({"caller": "c", "peer": "b"})) as per:
            for q in CL_COLOCATED:
                before = wire.breakers.total_requests()
                got = eng_c.query_range(q, *CL_RANGE)
                if q == "sum(rate(m[2m]))":
                    assert wire.breakers.total_requests() - before == 1
                assert cl_same(np, cl_answer(np, got), want[q]), \
                    ("coloc", q)
        launches["colocated"] = dict(per)
    finally:
        srv.stop()
    # replan once: node a holds both shards' stores (a survivor after
    # takeover); node b's server stops, the monitor removes b, the query
    # re-plans onto a
    mgr = ShardManager()
    mgr.add_node("a")
    mgr.add_node("b")
    mgr.add_dataset(CL_DS, 2, claimed={0: "a", 1: "b"})
    ms_b = cl_populate(np, pkg, dev, (1,), 2)
    srv_b = FiloHttpServer({CL_DS: QueryEngine(
        ms_b, CL_DS, ShardMapper(2), device=dev, cluster=mgr, node="b")},
        port=0).start()
    dead = f"127.0.0.1:{srv_b.port}"
    srv_b.stop()
    state = {"failed": False}

    def resolver(node):
        if node == "b" and not state["failed"]:
            state["failed"] = True
            mgr.remove_node("b")
            return dead
        return None

    eng = QueryEngine(cl_populate(np, pkg, dev, (0, 1), 2), CL_DS,
                      ShardMapper(2), device=dev, cluster=mgr, node="a",
                      endpoint_resolver=resolver)
    with k1_by_node(fg, by_thread({"caller": "a", "peer": "b"})) as per:
        r = eng.query_range("sum(rate(m[2m]))", *CL_RANGE)
    assert state["failed"] and r.exec_path == "local-replanned", r.exec_path
    assert cl_same(np, cl_answer(np, r), cl_answer(
        np, oracle2.query_range("sum(rate(m[2m]))", *CL_RANGE)))
    launches["replanned"] = dict(per)
    return launches


def cl_durable(np, fg, pkg, dev, root) -> dict:
    """One shard on ``dev`` flushes to a ReplicatedColumnStore (RF 2) over
    three StoreServers; the server holding the first replica stops; a
    fresh shard recovers through the survivors: its rows and its
    sum(rate) bit for bit the pre-crash ones."""
    from filodb_tpu_torch.core.diststore import (RemoteStore,
                                                 ReplicatedColumnStore,
                                                 StoreServer)
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    servers = [StoreServer(os.path.join(root, f"node{i}")).start()
               for i in range(3)]
    addrs = [f"127.0.0.1:{s.port}" for s in servers]
    q = "sum(rate(m[2m]))"
    try:
        def shard_on(sink):
            ms = TimeSeriesMemStore(device=dev)
            return ms, ms.setup(CL_DS, GAUGE, 0, StoreConfig(
                max_series_per_shard=32, samples_per_series=256,
                flush_batch_size=10**9, groups_per_shard=2, device=dev),
                sink=sink)

        ms, sh = shard_on(ReplicatedColumnStore(
            [RemoteStore(a) for a in addrs], 2))
        src = cl_populate(np, pkg, "cpu", (0,), 1).shard(CL_DS, 0)
        ts_all = CL_START + np.arange(CL_N, dtype=np.int64) * CL_IV
        b = RecordBuilder(GAUGE)
        for pid in range(src.num_series):
            labels = dict(src.index.labels_of(pid))
            _t, v = src.store.series_snapshot(pid)
            b.add_batch(labels, ts_all, np.asarray(v, np.float64))
        sh.ingest(b.build(), offset=0)
        sh.flush_all_groups()
        eng = QueryEngine(ms, CL_DS, ShardMapper(1), device=dev)
        with k1_by_node(fg, lambda _v: "before") as per:
            before = cl_answer(np, eng.query_range(q, *CL_RANGE))
        stores = [RemoteStore(a) for a in addrs]
        holders = [i for i, st in enumerate(stores)
                   if list(st.read_chunksets(CL_DS, 0))]
        assert len(holders) == 2, holders
        servers[holders[0]].stop()
        ms2, sh2 = shard_on(ReplicatedColumnStore(
            [RemoteStore(a, timeout_s=5.0, connect_timeout_s=1.0)
             for a in addrs], 2))
        sh2.recover()
        assert sh2.num_series == sh.num_series == 16
        for pid in range(sh.num_series):
            t1, v1 = sh.store.series_snapshot(pid)
            t2, v2 = sh2.store.series_snapshot(pid)
            assert np.array_equal(t1, t2) and np.array_equal(v1, v2), pid
        eng2 = QueryEngine(ms2, CL_DS, ShardMapper(1), device=dev)
        with k1_by_node(fg, lambda _v: "after") as per2:
            after = cl_answer(np, eng2.query_range(q, *CL_RANGE))
        assert cl_same(np, before, after), "recovered answer differs"
        return {**per, **per2}
    finally:
        for s in servers:
            with contextlib.suppress(OSError):
                s.stop()


def phase_cluster_small(torch, np, fg, pkg):
    """Phase 14a: the two-node fixture on the card and on the CPU (each
    bit for bit its device's one-node oracle, the card within rtol 1e-5 of
    the CPU), batched dispatch, the co-located reduce, replan-once, the
    metadata federation, and recovery through the replicated store ring.
    Returns K1's launches on the card by step and node."""
    import tempfile
    t0 = time.perf_counter()
    card, k1_two = cl_two_node(np, fg, pkg, "cuda")
    cpu, _ = cl_two_node(np, fg, pkg, "cpu")
    for (n, q), g in card.items():
        compare_result(np, q, g, cpu[(n, q)], False, route=None)
    k1 = {"two-node": k1_two}
    k1.update(cl_batched_colocated_replan(np, fg, pkg, "cuda"))
    cl_batched_colocated_replan(np, fg, pkg, "cpu")
    with tempfile.TemporaryDirectory(prefix="filodb-ring-") as tmp:
        k1["ring"] = cl_durable(np, fg, pkg, "cuda", tmp)
    with tempfile.TemporaryDirectory(prefix="filodb-ring-") as tmp:
        cl_durable(np, fg, pkg, "cpu", tmp)
    for step, per in k1.items():
        assert all(v > 0 for v in per.values()) and per, (step, per)
        assert "?" not in per, (step, per)
    log(f"cluster small: {len(CL_QUERIES)} queries on either node of two "
        f"(one shard each, HTTP /exec) bit for bit the one-node oracle on "
        f"the card and on the CPU, the card within rtol 1e-5 of the CPU; "
        f"batched dispatch one POST a peer, the co-located reduce one POST, "
        f"replan-once after a peer's server stopped, the metadata API "
        f"federated, a shard recovered through the store ring with one of "
        f"three servers down bit for bit; K1 launches on the card by step "
        f"and node {k1} ({time.perf_counter() - t0:.1f} s)")
    return sum(v for per in k1.values() for v in per.values())


def cl_http_query(ep, ds, q, s, e, step):
    import urllib.parse
    import urllib.request
    params = urllib.parse.urlencode({"query": q, "start": s / 1000.0,
                                     "end": e / 1000.0,
                                     "step": f"{step}ms"})
    url = f"http://{ep}/promql/{ds}/api/v1/query_range?{params}"
    with urllib.request.urlopen(url, timeout=600) as r:
        return json.load(r)


def cl_prom(res) -> dict:
    """The JSON the HTTP API renders for a result, read back."""
    from filodb_tpu_torch.http.api import matrix_to_prom_json
    return json.loads(json.dumps(matrix_to_prom_json(res)))


def adopt_shards(pkg, dev, dataset, shards):
    """A memstore holding ``shards`` (set up elsewhere) without a copy."""
    ms = pkg[1](device=dev)
    for sh in shards:
        ms._shards[(dataset, sh.shard_num)] = sh
        ms._configs[dataset] = sh.config
        ms._dataset_schema[dataset] = sh.schema
    return ms


def phase_cluster_scale(torch, np, fg, card, pkg, shards, dev="cuda"):
    """Phase 14b: phase 11b's 8 shards of 2^17 x 720 (adopted as they
    are, delta8-resident after M6) split 4/4 over nodes a and b in this
    process, queried over HTTP through node a, against one node's host
    loop over the same 8 shards: host ms p50, bytes on the wire a query,
    K1 launches by node; every answer bit for bit the host loop's."""
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.parallel.cluster import ShardManager
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    QueryEngine = pkg[4]
    ds = "meshq"
    n = len(shards)
    half = {"a": shards[:n // 2], "b": shards[n // 2:]}
    mgr = ShardManager()
    mgr.add_node("a")
    mgr.add_node("b")
    mgr.add_dataset(ds, n, claimed={sh.shard_num: node
                                    for node, shs in half.items()
                                    for sh in shs})
    eps: dict = {}
    engines = {node: QueryEngine(adopt_shards(pkg, dev, ds, shs), ds,
                                 ShardMapper(n), device=dev, cluster=mgr,
                                 node=node, endpoint_resolver=eps.get)
               for node, shs in half.items()}
    servers = {node: FiloHttpServer({ds: e}, port=0).start()
               for node, e in engines.items()}
    eps.update({node: f"127.0.0.1:{s.port}" for node, s in servers.items()})
    host = QueryEngine(adopt_shards(pkg, dev, ds, shards), ds,
                       ShardMapper(n), device=dev)
    s, e = range_variants(shards[0])[0]
    kinds = {sh.store.narrow_operands()[0] if sh.store.narrow_operands()
             else "raw" for sh in shards}
    out, by_kind = {}, dict.fromkeys(fg.fused_grid_kernel.launches_by_kind, 0)
    try:
        for name, q in CL_SCALE_QUERIES.items():
            reps = CL_SCALE_REPS[name]
            if reps > 1:      # warm both routes
                cl_http_query(eps["a"], ds, q, s, e, STEP_MS)
                host.query_range(q, s, e, STEP_MS)
            times, htimes = [], []
            reset_k1(fg)
            with k1_by_node(fg, by_store(half)) as per, wire_bytes() as wb:
                for _ in range(reps):
                    t0 = time.perf_counter()
                    got = cl_http_query(eps["a"], ds, q, s, e, STEP_MS)
                    times.append((time.perf_counter() - t0) * 1000)
            for k, v in fg.fused_grid_kernel.launches_by_kind.items():
                by_kind[k] += v
            for _ in range(reps):
                t0 = time.perf_counter()
                want = host.query_range(q, s, e, STEP_MS)
                np.asarray(want.matrix.values)
                htimes.append((time.perf_counter() - t0) * 1000)
            assert got["status"] == "success", got
            assert got["data"] == cl_prom(want), (name, "not bit-equal")
            assert got["stats"]["series_matched"] == NUM_SERIES, name
            out[name] = {"p50": float(np.percentile(times, 50)),
                         "stage_ms": got["stats"]["stage_ms"],
                         "host_p50": float(np.percentile(htimes, 50)),
                         "wire_bytes": wb["bytes"] / reps,
                         "posts": wb["posts"] / reps,
                         "k1": {k: v / reps for k, v in per.items()}}
            if name == "M1" and torch.device(dev).type == "cuda":
                assert out[name]["k1"] == {"a": 4, "b": 4}, out[name]["k1"]
            if name == "M1":
                # both nodes share this interpreter: the same calls with
                # the GIL handed over every 0.5 ms instead of 5 ms say how
                # much of the gap is threads waiting on each other
                swi = sys.getswitchinterval()
                sys.setswitchinterval(0.0005)
                try:
                    fast = []
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        cl_http_query(eps["a"], ds, q, s, e, STEP_MS)
                        fast.append((time.perf_counter() - t0) * 1000)
                finally:
                    sys.setswitchinterval(swi)
                out[name]["p50_switch_0.5ms"] = float(np.percentile(fast,
                                                                    50))
            assert out[name]["posts"] == 1, out[name]
    finally:
        for srv in servers.values():
            srv.stop()
    for name, q in CL_SCALE_QUERIES.items():
        r = out[name]
        log(f"cluster scale [{card}]: {name} {q}: two nodes over HTTP p50 "
            f"{r['p50']:.3f} ms (over {CL_SCALE_REPS[name]}), one node's "
            f"host loop p50 {r['host_p50']:.3f} ms; {r['wire_bytes']:.0f} "
            f"bytes on the wire in {r['posts']:g} POST; K1 ({sorted(kinds)}) "
            f"launches by node {r['k1']}; bit-equal to the host loop; the "
            f"last call's stage ms, both nodes summed {r['stage_ms']}"
            + (f"; two nodes p50 {r['p50_switch_0.5ms']:.3f} ms with the "
               f"interpreter's switch interval at 0.5 ms"
               if "p50_switch_0.5ms" in r else ""))
    return by_kind, out


def phase_cluster_procs(torch, np, fg, card, pkg, dev="cuda"):
    """Phase 14c: two fresh interpreters, each a cluster node
    (``filodb_tpu_torch.entry --cluster-node``: file registrar, world,
    Gloo process group, membership, one seeded 2^17 x 720 shard on the
    card, HTTP); this process builds both shards on one node as the
    oracle. Both nodes' M1 and topk equal each other's and the oracle's
    bit for bit, and each rank's all_reduce of its partials gives M1.
    Returns K1's launches in the nodes during the queries."""
    import subprocess
    import tempfile

    from filodb_tpu_torch.entry import seeded_counter_shard
    from filodb_tpu_torch.parallel.bootstrap import free_port
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    QueryEngine = pkg[4]
    t_all = time.perf_counter()
    s = BASE_TS + WINDOW_MS
    e = BASE_TS + NUM_SAMPLES * INTERVAL_MS
    with tempfile.TemporaryDirectory(prefix="filodb-nodes-") as tmp:
        reg = os.path.join(tmp, "members")
        port = free_port()
        procs, logs = [], []
        try:
            for addr in (f"127.0.0.1:{port}", f"127.0.0.2:{port}"):
                lg = os.path.join(tmp, addr.replace(":", "_") + ".log")
                logs.append(lg)
                with open(lg, "w") as fh:
                    # output to a file: a chatty child must not block on a
                    # full pipe and stall its heartbeats
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "filodb_tpu_torch.entry",
                         "--cluster-node", "--registrar", reg, "--addr",
                         addr, "--series", str(CL_PROC_SERIES), "--samples",
                         str(NUM_SAMPLES), "--capacity", str(CAPACITY),
                         "--seed", str(CL_PROC_SEED), "--device", dev,
                         "--range", f"{s},{e},{STEP_MS}"],
                        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                        stdout=fh, stderr=subprocess.STDOUT))

            def lines(tag):
                got = []
                for p, lg in zip(procs, logs):
                    with open(lg) as fh:
                        text = fh.read()
                    assert p.poll() in (None, 0), text[-3000:]
                    got += [json.loads(ln[len(tag) + 1:])
                            for ln in text.splitlines()
                            if ln.startswith(tag + " ")]
                return got

            # the oracle builds while the nodes start
            t0 = time.perf_counter()
            oms = pkg[1](device=dev)
            for sh in (0, 1):
                seeded_counter_shard(oms, "prometheus", sh, CL_PROC_SERIES,
                                     NUM_SAMPLES, CAPACITY, CL_PROC_SEED)
            oracle = QueryEngine(oms, "prometheus", ShardMapper(2),
                                 device=dev)
            want = {q: oracle.query_range(q, s, e, STEP_MS)
                    for q in CL_PROC_QUERIES}
            oracle_s = time.perf_counter() - t0
            deadline = time.monotonic() + 600
            while len(lines("NODE")) < 2:
                assert time.monotonic() < deadline, "nodes never came up"
                time.sleep(0.5)
            up_s = time.perf_counter() - t_all
            nodes = sorted(lines("NODE"), key=lambda x: x["rank"])
            assert [(x["rank"], x["world"]) for x in nodes] == [(0, 2),
                                                                 (1, 2)]
            (_k, _t, m1), = list(want[CL_PROC_QUERIES[0]].matrix
                                 .iter_series())
            lat = {}
            for x in nodes:
                assert x["allreduce"] == [float(v) for v in m1], x["rank"]
                for q in CL_PROC_QUERIES:
                    times = []
                    for _ in range(1 + CL_PROC_REPS):     # one warm run
                        t0 = time.perf_counter()
                        got = cl_http_query(x["http"], "prometheus", q, s,
                                            e, STEP_MS)
                        times.append((time.perf_counter() - t0) * 1000)
                        assert got["data"] == cl_prom(want[q]), \
                            (x["rank"], q)
                    lat[(x["rank"], q)] = (times[0], float(
                        np.percentile(times[1:], 50)))
            open(os.path.join(reg, "stop"), "w").close()
            for p in procs:
                assert p.wait(timeout=120) == 0
            done = {x["rank"]: x["k1_launches"] for x in lines("DONE")}
            k1 = {x["rank"]: done[x["rank"]] - x["k1_launches"]
                  for x in nodes}
        finally:
            open(os.path.join(reg, "stop"), "a").close()
            for p in procs:
                if p.poll() is None:
                    p.terminate()
                    with contextlib.suppress(subprocess.TimeoutExpired):
                        p.wait(timeout=20)
                if p.poll() is None:
                    p.kill()
    if torch.device(dev).type == "cuda":
        # M1 launches K1 once a node a call, through either node
        assert k1 == {0: 2 * (1 + CL_PROC_REPS),
                      1: 2 * (1 + CL_PROC_REPS)}, k1
    log(f"cluster procs [{card}]: two node processes (Gloo world of 2, "
        f"file registrar, membership) with one {CL_PROC_SERIES} x "
        f"{NUM_SAMPLES} shard "
        f"each on the card, up in {up_s:.1f} s (registration "
        f"{[round(x['registration_s'], 1) for x in nodes]} s; the one-node "
        f"oracle of both shards built in {oracle_s:.1f} s meanwhile); M1 "
        f"and topk on both nodes bit for bit the oracle; each rank's Gloo "
        f"all_reduce of its partials equals M1; host ms by (rank, query), "
        f"the first call then the p50 over {CL_PROC_REPS} "
        f"{ {f'{r}:{q}': (round(a, 3), round(b, 3)) for (r, q), (a, b) in lat.items()} }; "
        f"K1 launches by rank {k1} ({time.perf_counter() - t_all:.1f} s)")
    return sum(k1.values())


# phase 15: the standalone server and its ingest plane
SV_DS = "prometheus"
SV_SHARDS = 4
SV_SERIES = 256                 # 15a: counters through the broker
SV_SAMPLES = 64                 # a series, 10 s apart
SV_BATCH = 8                    # samples a SyntheticStream batch
SV_GW_SERIES = 32               # 15a: gateway series x SV_GW_SAMPLES lines
SV_GW_SAMPLES = 10
SV_QUERIES = ("sum(rate(m[5m]))", "sum by (dc) (rate(m[5m]))",
              "avg_over_time(m[5m])")
SV_FUSED = {"sum(rate(m[5m]))": True, "sum by (dc) (rate(m[5m]))": True,
            "avg_over_time(m[5m])": False}
SV_STEP = 30_000
SV_RANGE = (BASE_TS + 300_000, BASE_TS + (SV_SAMPLES - 1) * 10_000)
SV_CHURN_SERIES = 8              # 15a: gateway series born mid-stream
SV_CHURN_FROM = SV_SAMPLES // 2  # their first sample
SV_SCALE_SERIES = 1 << 15       # 15b: a shard (2^17 in all)
SV_SCALE_BATCH = 16             # 15b: samples a SyntheticStream batch
SV_SCALE_REPS = 5


def sv_split(np, c, mapper, nshards):
    """One SyntheticStream container -> {shard: container} by the server's
    shard mapper (the routing a producer does: each series' samples go to
    its shard's partition)."""
    from filodb_tpu_torch.core.record import RecordContainer
    keys, hashes = c.resolved_keys()
    first = np.zeros(len(keys), np.int64)
    first[c.part_idx[::-1]] = np.arange(len(c.part_idx))[::-1]
    set_shard = mapper.shards_vector(c.shard_hash[first], c.part_hash[first])
    row_shard = set_shard[c.part_idx]
    out = {}
    for s in range(nshards):
        rows = np.nonzero(row_shard == s)[0]
        if not len(rows):
            continue
        used = np.nonzero(set_shard == s)[0]
        remap = np.full(len(keys), -1, np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        out[s] = RecordContainer(
            c.schema, c.ts[rows], c.values[rows], c.part_hash[rows],
            c.shard_hash[rows], remap[c.part_idx[rows]],
            [c.label_sets[i] for i in used], None,
            [keys[i] for i in used], hashes[used])
    return out


def sv_stream(np, mapper, n_series, n_samples, batch):
    """The counters of ``SyntheticStream`` (FiloDB's TestTimeseriesProducer
    counterpart) as metric m on BASE_TS's 10 s grid: a list of
    {shard: container}, one a batch of ``batch`` samples a series."""
    from filodb_tpu_torch.ingest.stream import SyntheticStream
    stream = SyntheticStream(n_series=n_series, n_batches=n_samples // batch,
                             samples_per_batch=batch, start_ms=BASE_TS,
                             interval_ms=10_000, metric="m", kind="counter")
    return [sv_split(np, c, mapper, SV_SHARDS) for _off, c in stream]


def sv_brokers(tmp, plan=None):
    """Two BrokerServer nodes: 4 partitions, replication 2, min_insync 2,
    epoch fencing; node 0 (the leader of partitions 0 and 2) takes
    ``plan``. Returns (addrs, [node0, node1], start(i)) — start(i) brings
    node i (back) up on its port and directory."""
    from filodb_tpu_torch.ingest.broker import BrokerServer
    from filodb_tpu_torch.parallel.bootstrap import free_port
    ports = [free_port(), free_port()]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    nodes = [None, None]

    def start(i, fault_plan=None):
        nodes[i] = BrokerServer(os.path.join(tmp, f"broker{i}"), SV_SHARDS,
                                port=ports[i], peers=addrs, node_index=i,
                                replication=2, min_insync=2,
                                epoch_fencing=True,
                                fault_plan=fault_plan).start()
        return nodes[i]

    start(0, plan)
    start(1)
    return addrs, nodes, start


def sv_config(addrs, **over):
    """The FiloServer config of phase 15: 4 shards over the broker pair
    (spread 2: a metric's series spread over all 4), the serving caches
    off (every query executes, through K1 where it fuses)."""
    from filodb_tpu_torch.config import Config, _deep_merge
    base = {
        "num_shards": SV_SHARDS, "spread": 2, "bus_addrs": addrs,
        "ingest": {"partitions": SV_SHARDS, "replication": 2,
                   "min_insync": 2, "epoch_fencing": True,
                   "retry_backoff": "20ms", "publish_retries": 16},
        "http": {"port": 0},
        "query": {"result_cache_size": 0, "negative_cache_size": 0,
                  "fragment_cache_size": 0},
        "store": {"max_series_per_shard": 1024, "samples_per_series": 128,
                  "flush_batch_size": 10**9, "groups_per_shard": 4},
    }
    return Config(_deep_merge(base, over))


def sv_publisher(addrs, part):
    from filodb_tpu_torch.ingest.broker import BrokerBus
    return BrokerBus(addrs, part, publish_window=8, retry_backoff_ms=20,
                     max_retries=16, epoch_fencing=True, track_acks=True)


def sv_publish(buses, batches):
    """Publish each batch's shard containers to their partitions (windowed,
    acked); returns the rows published."""
    rows = 0
    for per_shard in batches:
        for s, c in sorted(per_shard.items()):
            buses[s].publish_batch([c])
            rows += len(c)
    return rows


def sv_gateway_lines():
    """Influx lines for metric m: SV_GW_SERIES counters x SV_GW_SAMPLES
    samples on the stream's 10 s grid from its start (nanosecond
    timestamps). On the grid, so the shards stay on K1's route; from the
    start, because a series whose first resident sample is later than a
    query's data start pages the shard's whole selection in from the sink
    (core/memstore.py::needs_paging), at the sink's f64 precision, where
    the direct memstore has no sink."""
    out = []
    for t in range(SV_GW_SAMPLES):
        ts_ns = (BASE_TS + t * 10_000) * 1_000_000
        for i in range(SV_GW_SERIES):
            out.append(f"m,instance=gw-{i},dc=DC{i % 2},host=G{i % 4} "
                       f"value={(i + 1) * (t + 1)}.0 {ts_ns}")
    return out


def sv_churn_lines():
    """Influx lines for SV_CHURN_SERIES counters of metric m born at sample
    SV_CHURN_FROM (series churn: a live node's new series start after a
    query's data start)."""
    out = []
    for t in range(SV_CHURN_FROM, SV_SAMPLES):
        ts_ns = (BASE_TS + t * 10_000) * 1_000_000
        for i in range(SV_CHURN_SERIES):
            out.append(f"m,instance=churn-{i},dc=DC{i % 2},host=C{i % 4} "
                       f"value={(i + 1) * (t + 1)}.0 {ts_ns}")
    return out


def sv_send_lines(port, lines):
    import socket
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(("\n".join(lines) + "\n").encode())


def sv_oracle(np, pkg, dev, addrs, cfg):
    """A port memstore on ``dev`` that ingested every partition's
    containers straight from the broker (the same bytes the server
    consumed), shard p from partition p; its engine."""
    from filodb_tpu_torch.core.schemas import Schemas
    from filodb_tpu_torch.ingest.broker import BrokerBus
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    StoreConfig, TimeSeriesMemStore, _rb, GAUGE, QueryEngine = pkg
    ms = TimeSeriesMemStore(device=dev)
    for s in range(SV_SHARDS):
        ms.setup(SV_DS, GAUGE, s, cfg.store_config())
        bus = BrokerBus(addrs, s)
        try:
            for off, c in bus.consume(Schemas()):
                ms.ingest(SV_DS, s, c, off)
        finally:
            bus.close()
    ms.flush_all()
    return QueryEngine(ms, SV_DS, ShardMapper(SV_SHARDS, 2), device=dev)


def sv_http(ep, q, rng=SV_RANGE):
    return cl_http_query(ep, SV_DS, q, rng[0], rng[1], SV_STEP)


def sv_wait(what, cond, timeout_s=120.0, poll_s=0.1):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if cond():
                return
        except OSError:
            pass                        # a node still coming up
        assert time.monotonic() < deadline, f"{what}: timed out"
        time.sleep(poll_s)


def sv_want(oracle):
    return {q: cl_prom(oracle.query_range(q, SV_RANGE[0], SV_RANGE[1],
                                          SV_STEP)) for q in SV_QUERIES}


def sv_check(fg, eps, want, what, dev="cuda") -> int:
    """Every query on every endpoint over HTTP bit for bit ``want`` (the
    JSON the oracle's result renders); K1 launched once a shard leaf for
    the fused ones (4 a query, on the card). Returns K1's launches."""
    total = 0
    for ep in eps:
        for q in SV_QUERIES:
            reset_k1(fg)
            body = sv_http(ep, q)
            launched = fg.fused_grid_kernel.launches
            total += launched
            assert body["data"] == want[q], (what, ep, q)
            fused = body["stats"]["fused_kernels"]
            assert fused == (SV_SHARDS if SV_FUSED[q] else 0), \
                (what, ep, q, fused)
            if dev == "cuda":
                assert launched == fused, (what, ep, q, launched, fused)
    return total


def sv_close(np, got, want, what) -> float:
    """Two Prometheus JSON answers: the same series and steps, values within
    rtol 1e-5 of the largest magnitude. Returns the largest |diff|."""
    g = {json.dumps(r["metric"], sort_keys=True): r["values"]
         for r in got["result"]}
    w = {json.dumps(r["metric"], sort_keys=True): r["values"]
         for r in want["result"]}
    assert set(g) == set(w), what
    worst = 0.0
    for k, wv in w.items():
        gv = g[k]
        assert [t for t, _ in gv] == [t for t, _ in wv], (what, k)
        a = np.array([float(v) for _, v in gv])
        b = np.array([float(v) for _, v in wv])
        scale = max(float(np.nanmax(np.abs(b))), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                   equal_nan=True, err_msg=f"{what} {k}")
        fin = np.isfinite(b)
        if fin.any():
            worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
    return worst


def sv_cpu_close(np, ep_cpu, want, what) -> float:
    """The CPU server's answers within rtol 1e-5 of ``want``, waiting for
    it to catch up (its consumers poll on their own cadence). Returns the
    largest |diff|."""
    def near():
        try:
            for q in SV_QUERIES:
                sv_close(np, sv_http(ep_cpu, q)["data"], want[q], q)
        except AssertionError:
            return False
        return True
    sv_wait(what, near, 60, 0.2)
    return max(sv_close(np, sv_http(ep_cpu, q)["data"], want[q],
                        f"{what} {q}") for q in SV_QUERIES)


@contextlib.contextmanager
def sv_k1_args(fg, seen: list):
    """Keep the arguments of every K1 pass the engine makes (for the
    kernel-against-twin check on a server's own shard store)."""
    real = fg.fused_grid_partials

    def recording(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)

    fg.fused_grid_partials = recording
    try:
        yield
    finally:
        fg.fused_grid_partials = real


def sv_k1_vs_twin(torch, fg, server, ep, dev, rng=SV_RANGE) -> float:
    """One HTTP sum(rate) over ``rng`` on ``server``; for each K1 pass it
    made, K1 again on the same operands (the shard store's own block)
    against ``fused_grid_aggregate_plain``: counts bit for bit, sums within
    rtol 1e-5 of the largest magnitude. Returns the largest |diff|."""
    seen: list = []
    with sv_k1_args(fg, seen):
        sv_http(ep, SV_QUERIES[0], rng)
    assert len(seen) == SV_SHARDS, len(seen)
    ptrs = {sh.store.val.data_ptr(): sh.shard_num
            for sh in server.memstore.shards_of(SV_DS)}
    worst = 0.0
    before = fg.fused_grid_kernel.launches
    for a, kw in seen:
        fn, needs_sumsq, window_ms, interval_ms, val = a[:5]
        assert val.data_ptr() in ptrs, "K1 streamed a block not the server's"
        got = fg.fused_grid_partials(*a, **kw)
        ref = fg.fused_grid_aggregate_plain(*a, **kw)
        for i, (g, r) in enumerate(zip(got, ref)):
            g = g.double().cpu()
            r = r.double().cpu()
            if i == 1:
                assert torch.equal(g, r), "K1 counts differ from the twin"
            else:
                scale = max(float(r.abs().max()), 1e-30)
                d = float((g - r).abs().max())
                assert d <= 1e-5 * scale, (d, scale)
                worst = max(worst, d)
    # the comparison launches are not the main path's
    fg.fused_grid_kernel.launches = before
    return worst


def sv_churn(np, fg, srv, eps, settle_near, dev) -> dict:
    """Series churn on a sink-backed server: SV_CHURN_SERIES counters born
    mid-stream through the gateway. A shard whose selection holds a series
    born after the query's data start pages that selection in from the
    sink (core/memstore.py::needs_paging, the f64 paged route), so K1 does
    not run on that leaf. The answers are held within rtol 1e-5 of a
    sink-less memstore fed the broker directly (which runs K1 on every
    shard); per query the rows paged in and K1's launches are returned."""
    lines = sv_churn_lines()
    g0 = srv.gateway._rows.value
    sv_send_lines(srv.gateway.port, lines)
    sv_wait("churn gateway", lambda: srv.gateway._rows.value
            >= g0 + len(lines), 30, 0.02)
    srv.gateway.bus_drain()
    want = settle_near("churn", eps)
    out = {"rows": len(lines), "max_diff": 0.0, "queries": {}}
    for q in SV_QUERIES:
        per = []
        for ep in eps:
            reset_k1(fg)
            body = sv_http(ep, q)
            launched = fg.fused_grid_kernel.launches
            st = body["stats"]
            if dev == "cuda":
                assert launched == st["fused_kernels"], (q, ep, launched)
            out["max_diff"] = max(out["max_diff"], sv_close(
                np, body["data"], want[q], f"churn {q}"))
            per.append({"rows_paged_in": st["rows_paged_in"],
                        "fused_kernels": st["fused_kernels"],
                        "k1": launched})
        out["queries"][q] = per
    paged = [p["rows_paged_in"] for p in out["queries"][SV_QUERIES[0]]]
    assert sum(paged) > 0, "churn: no leaf paged in from the sink"
    out["k1"] = sum(p["k1"] for per in out["queries"].values() for p in per)
    return out


@contextlib.contextmanager
def sv_k1_events(torch, fg, pairs: list):
    """CUDA events around every K1 pass the engine makes (on the server's
    own threads), on the stream of the pass's device: (start, end) pairs
    appended to ``pairs``. Touches no launch count."""
    real = fg.fused_grid_partials

    def timed(*a, **kw):
        val = a[4]
        if not val.is_cuda:
            return real(*a, **kw)
        stream = torch.cuda.current_stream(val.device)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
        r = real(*a, **kw)
        ev[1].record(stream)
        pairs.append(ev)
        return r

    fg.fused_grid_partials = timed
    try:
        yield
    finally:
        fg.fused_grid_partials = real


@contextlib.contextmanager
def sv_stage_clocks(acc: dict):
    """Host seconds, summed over threads, of the ingest path's stages: the
    publisher's container encode (RecordContainer.to_bytes), the consumer's
    decode (RecordContainer.from_bytes, on its decode-ahead thread) and the
    shard's ingest (TimeSeriesShard.ingest, on the consumer thread)."""
    from filodb_tpu_torch.core.memstore import TimeSeriesShard
    from filodb_tpu_torch.core.record import RecordContainer
    for k in ("encode", "decode", "ingest"):
        acc[k] = []
    to_bytes = RecordContainer.to_bytes
    from_bytes = RecordContainer.__dict__["from_bytes"]
    ingest = TimeSeriesShard.ingest

    def enc(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return to_bytes(self, *a, **kw)
        finally:
            acc["encode"].append(time.perf_counter() - t0)

    def dec(cls, *a, **kw):
        t0 = time.perf_counter()
        try:
            return from_bytes.__func__(cls, *a, **kw)
        finally:
            acc["decode"].append(time.perf_counter() - t0)

    def ing(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return ingest(self, *a, **kw)
        finally:
            acc["ingest"].append(time.perf_counter() - t0)

    RecordContainer.to_bytes = enc
    RecordContainer.from_bytes = classmethod(dec)
    TimeSeriesShard.ingest = ing
    try:
        yield
    finally:
        RecordContainer.to_bytes = to_bytes
        RecordContainer.from_bytes = from_bytes
        TimeSeriesShard.ingest = ingest


def sv_device_ms(torch, prof) -> float:
    """Device time (ms) of every kernel and copy in a torch.profiler trace."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


def sv_audit(np, nodes, buses) -> dict:
    """The pub-id audit over both broker nodes: per partition dense offsets,
    unique pub-ids, every acked id logged, both nodes' logs and journals
    identical. Returns {partition: frames}."""
    out = {}
    for p in range(SV_SHARDS):
        items = [n._journals[p].items() for n in nodes]
        assert items[0] == items[1], f"partition {p}: journals differ"
        offs = [o for o, _ in items[0]]
        ids = [i for _, i in items[0]]
        assert offs == list(range(len(offs))), f"partition {p}: gaps"
        assert len(set(ids)) == len(ids), f"partition {p}: duplicates"
        assert set(buses[p].acked_ids) <= set(ids), f"partition {p}: lost"
        f0 = [f for _o, f in nodes[0]._parts[p].frames_from(0)]
        f1 = [f for _o, f in nodes[1]._parts[p].frames_from(0)]
        assert f0 == f1, f"partition {p}: logs differ"
        out[p] = len(offs)
    return out


def phase_server_small(torch, np, fg, pkg, dev="cuda") -> dict:
    """Phase 15a: the server path at small size. Two BrokerServer nodes
    (4 partitions, replication 2, min_insync 2, epoch fencing), a
    FiloServer on ``dev`` with 4 shards, a data_dir sink, the gateway and a
    file registrar, and a CPU FiloServer on the same brokers; SV_SERIES
    SyntheticStream counters x SV_SAMPLES through BrokerBus and
    SV_GW_SERIES x SV_GW_SAMPLES Influx lines through the gateway. The
    queries over HTTP bit for bit a port memstore on ``dev`` fed the
    broker's containers directly, within rtol 1e-5 of the CPU server;
    K1 once a shard leaf and against its twin on the server's own store.
    Then the leader broker killed mid-stream by a FaultPlan (and brought
    back: min_insync 2), the pub-id audit, a restart of the server from its
    sink and the broker's replay, and a live move of one shard to a second
    FiloServer through POST /api/v1/cluster/rebalance: the answers stay
    bit for bit the oracle's after each. Last, SV_CHURN_SERIES counters
    born mid-stream through the gateway: the shards holding them page
    their selections in from the sink (off K1's route), held within rtol
    1e-5 of the oracle, with the rows paged in and K1's launches a query.
    The gateway series and the stream's counters all start at the
    stream's first sample, so that until then no leaf pages."""
    import tempfile
    import threading
    import urllib.request

    from filodb_tpu_torch.ingest.faults import FaultPlan, FaultRule
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    from filodb_tpu_torch.standalone import FiloServer
    t_all = time.perf_counter()
    out = {"k1": 0}
    mapper = ShardMapper(SV_SHARDS, 2)
    batches = sv_stream(np, mapper, SV_SERIES, SV_SAMPLES, SV_BATCH)
    half = len(batches) // 2
    kill = FaultRule("append", "kill_server", partition=0,
                     at_offset=1 << 40)
    plan = FaultPlan([kill])
    servers: list = []
    buses: dict = {}
    with tempfile.TemporaryDirectory(prefix="filodb-server-") as tmp:
        addrs, nodes, start_broker = sv_brokers(tmp, plan)
        try:
            reg = os.path.join(tmp, "members")
            cluster = {"registrar": reg, "heartbeat_interval": "200ms",
                       "stale_after": "10s", "min_members": 1,
                       "join_timeout": "15s", "shard_fencing": True}
            cfg_a = sv_config(addrs, data_dir=os.path.join(tmp, "data"),
                              cluster=dict(cluster, self_addr="node-a"),
                              ingest={"gateway_port": 0,
                                      "gateway_flush_interval": "100ms"})
            srv = FiloServer(cfg_a, device=dev).start()
            servers.append(srv)
            cpu = FiloServer(sv_config(addrs), device="cpu").start()
            servers.append(cpu)
            ep, ep_cpu = (f"127.0.0.1:{srv.http.port}",
                          f"127.0.0.1:{cpu.http.port}")
            buses.update({p: sv_publisher(addrs, p)
                          for p in range(SV_SHARDS)})
            rows = sv_publish(buses, batches[:half])
            lines = sv_gateway_lines()
            g0 = srv.gateway._rows.value
            sv_send_lines(srv.gateway.port, lines)
            # the gateway builds on its 100 ms cadence; its windowed
            # publishers drain into the broker (acked) on bus_drain
            sv_wait("gateway", lambda: srv.gateway._rows.value
                    >= g0 + len(lines), 30, 0.02)
            srv.gateway.bus_drain()

            def converged(want, eps):
                return all(sv_http(e, q)["data"] == want[q]
                           for e in eps for q in SV_QUERIES)

            def settle(what, eps):
                # the oracle reads the broker as it is; the servers catch
                # up within a poll or two
                oracle = sv_oracle(np, pkg, dev, addrs, cfg_a)
                want = sv_want(oracle)
                sv_wait(what, lambda: converged(want, eps), 60, 0.2)
                return oracle, want

            def settle_near(what, eps):
                # as settle, held at rtol 1e-5 (the paged route's f64)
                want = sv_want(sv_oracle(np, pkg, dev, addrs, cfg_a))

                def near():
                    try:
                        for e in eps:
                            for q in SV_QUERIES:
                                sv_close(np, sv_http(e, q)["data"], want[q],
                                         q)
                    except AssertionError:
                        return False
                    return True
                sv_wait(what, near, 60, 0.2)
                return want

            oracle, want = settle("first half", [ep])
            out["k1"] += sv_check(fg, [ep], want, "first half", dev)
            out["max_cpu_diff"] = sv_cpu_close(np, ep_cpu, want, "cpu")
            route = srv.engines[SV_DS].query_range(
                SV_QUERIES[0], SV_RANGE[0], SV_RANGE[1], SV_STEP)
            out["route"] = (route.exec_path, route.stats.fused_kernels)
            assert route.exec_path == "local" \
                and route.stats.fused_kernels == SV_SHARDS, out["route"]
            out["k1_vs_twin"] = sv_k1_vs_twin(torch, fg, srv, ep, dev)

            # the leader broker dies mid-stream: node 0 leads partition 0
            kill.at_offset = nodes[0]._parts[0].end_offset + 2
            t0 = time.perf_counter()
            errs: list = []

            def second_half():
                try:
                    sv_publish(buses, batches[half:])
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)

            pub = threading.Thread(target=second_half, name="sv-publish")
            pub.start()
            sv_wait("kill", lambda: plan.fired, 60, 0.02)
            # min_insync 2: the survivor sheds RETRY until the dead node
            # comes back (REJOIN: its divergent tail truncated, caught up)
            sv_wait("dead node down", lambda: nodes[0]._stopped
                    and nodes[0]._thread is None, 30, 0.02)
            start_broker(0)
            pub.join(timeout=120)
            assert not pub.is_alive() and not errs, errs
            out["failover_s"] = time.perf_counter() - t0
            out["failovers"] = {p: b.failover_count for p, b in buses.items()}
            rows += sum(len(c) for per in batches[half:]
                        for c in per.values())
            out["rows"] = rows + len(lines)
            sv_wait("rejoin", lambda: all(
                nodes[0]._parts[p].end_offset == nodes[1]._parts[p].end_offset
                for p in range(SV_SHARDS)), 60, 0.1)
            out["frames"] = sv_audit(np, nodes, buses)
            oracle, want = settle("after failover", [ep])
            out["k1"] += sv_check(fg, [ep], want, "after failover", dev)
            out["max_cpu_diff"] = max(out["max_cpu_diff"], sv_cpu_close(
                np, ep_cpu, want, "cpu after failover"))

            # restart the server from its sink and the broker's replay
            t0 = time.perf_counter()
            srv.shutdown()
            servers.remove(srv)
            srv = FiloServer(cfg_a, device=dev).start()
            servers.append(srv)
            ep = f"127.0.0.1:{srv.http.port}"
            sv_wait("restart", lambda: converged(want, [ep]), 60, 0.2)
            out["restart_s"] = time.perf_counter() - t0
            out["k1"] += sv_check(fg, [ep], want, "after restart", dev)

            # a live move of one shard to a second node
            cfg_b = sv_config(addrs, data_dir=os.path.join(tmp, "data"),
                              cluster=dict(cluster, self_addr="node-b"))
            srv_b = FiloServer(cfg_b, device=dev).start()
            servers.append(srv_b)
            ep_b = f"127.0.0.1:{srv_b.http.port}"
            sv_wait("b joined", lambda: "node-b" in srv.manager.nodes
                    and srv._resolve_endpoint("node-b") is not None, 30)
            assert srv_b.manager.shards_of_node(SV_DS, "node-b") == []
            moved = SV_SHARDS - 1
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f"http://{ep}/api/v1/cluster/rebalance?dataset={SV_DS}"
                f"&shard={moved}&to=node-b", method="POST", data=b"")
            with urllib.request.urlopen(req, timeout=120) as r:
                reb = json.load(r)["data"]
            assert reb["to"] == "node-b", reb
            sv_wait("rebalance", lambda: converged(want, [ep, ep_b]), 60,
                    0.2)
            out["rebalance_s"] = time.perf_counter() - t0
            assert srv.manager.node_of(SV_DS, moved) == "node-b"
            assert srv_b.manager.node_of(SV_DS, moved) == "node-b"
            assert moved in srv_b._fence.owned()
            out["k1"] += sv_check(fg, [ep, ep_b], want, "after rebalance",
                                  dev)

            # series churn: counters born mid-stream page their shards'
            # selections in from the sink, off K1's route
            out["churn"] = sv_churn(np, fg, srv, [ep, ep_b], settle_near,
                                    dev)
            out["k1"] += out["churn"]["k1"]
        finally:
            for b in buses.values():
                b.close()
            for s in servers:
                s.shutdown()
            for n in nodes:
                with contextlib.suppress(Exception):
                    n.stop()
    out["seconds"] = time.perf_counter() - t_all
    return out


def phase_server_scale(torch, np, fg, card, pkg, dev="cuda") -> dict:
    """Phase 15b: the server path at a deployment's size: 4 shards x
    2^15 SyntheticStream counters (2^17 series) x 64 samples at 10 s, 8.4 M
    samples through the two-node replicated broker into a FiloServer on
    ``dev``. Prints publish rows/s, ingest rows/s (first publish to every
    shard's consumer past the partition's end), the time from the last
    publish until every sample answers, the host ms p50 over HTTP of
    sum(rate(m[5m])) over all 2^17 series (K1 once a shard: 4 a query),
    the card's memory in use; the answer bit for bit a port memstore fed
    the same containers directly. On the card it also prints: the host
    seconds of the ingest stages (encode, decode, shard ingest; summed
    over threads), the card's busy share over the ingest window
    (torch.profiler, device activity only, which traces that window),
    CUDA events around K1's four passes of one query (the stream idles
    between passes, so they hold each pass's host launch work too), and
    from SV_SCALE_REPS traced queries K1's device time a launch, their
    device ms and busy share of their host wall."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    from filodb_tpu_torch.standalone import FiloServer
    StoreConfig, TimeSeriesMemStore, _rb, GAUGE, QueryEngine = pkg
    t_all = time.perf_counter()
    n_series = SV_SCALE_SERIES * SV_SHARDS
    mapper = ShardMapper(SV_SHARDS, 2)
    t0 = time.perf_counter()
    batches = sv_stream(np, mapper, n_series, SV_SAMPLES, SV_SCALE_BATCH)
    build_s = time.perf_counter() - t0
    assert all(s in per for per in batches for s in range(SV_SHARDS))
    cap = max(len(batches[0][s].label_sets) for s in range(SV_SHARDS))
    rows = sum(len(c) for per in batches for c in per.values())
    out: dict = {"rows": rows, "build_s": build_s}
    servers: list = []
    buses: dict = {}
    with tempfile.TemporaryDirectory(prefix="filodb-server-scale-") as tmp:
        addrs, nodes, _start = sv_brokers(tmp)
        try:
            cfg = sv_config(addrs, store={
                "max_series_per_shard": cap, "samples_per_series": 128})
            srv = FiloServer(cfg, device=dev).start()
            servers.append(srv)
            ep = f"127.0.0.1:{srv.http.port}"
            buses.update({p: sv_publisher(addrs, p)
                          for p in range(SV_SHARDS)})
            on_card = torch.device(dev).type == "cuda"
            stages: dict = {}
            # the ingest window under torch.profiler (device activity
            # only): the card's busy share while the broker feeds it
            with contextlib.ExitStack() as trace:
                prof = (trace.enter_context(profile(
                    activities=[ProfilerActivity.CUDA])) if on_card
                    else None)
                trace.enter_context(sv_stage_clocks(stages))
                t_pub0 = time.perf_counter()
                sv_publish(buses, batches)
                t_pub1 = time.perf_counter()
                ends = {p: nodes[0]._parts[p].end_offset
                        for p in range(SV_SHARDS)}
                sv_wait("consumed", lambda: all(
                    c._offset >= ends[c.shard.shard_num]
                    for c in srv.consumers), 300, 0.01)
                if on_card:
                    torch.cuda.synchronize()
                t_cons = time.perf_counter()
            out["stages_s"] = {k: sum(v) for k, v in stages.items()}
            out["stages_n"] = {k: len(v) for k, v in stages.items()}
            if prof is not None:
                out["ingest_device_ms"] = sv_device_ms(torch, prof)
                out["ingest_busy"] = (out["ingest_device_ms"]
                                      / ((t_cons - t_pub0) * 1e3))
            full = f"sum(count_over_time(m[{SV_SAMPLES * 10}s]))"

            def all_visible():
                body = cl_http_query(ep, SV_DS, full, SV_RANGE[1],
                                     SV_RANGE[1], SV_STEP)
                res = body["data"]["result"]
                return res and float(res[0]["values"][-1][1]) == rows
            sv_wait("queryable", all_visible, 300, 0.05)
            t_vis = time.perf_counter()
            out.update(publish_s=t_pub1 - t_pub0,
                       publish_rows_s=rows / (t_pub1 - t_pub0),
                       ingest_rows_s=rows / (t_cons - t_pub0),
                       visible_after_s=t_vis - t_pub1)
            # the oracle: the same containers ingested directly
            oms = TimeSeriesMemStore(device=dev)
            for s in range(SV_SHARDS):
                oms.setup(SV_DS, GAUGE, s, cfg.store_config())
            for per in batches:
                for s, c in per.items():
                    oms.ingest(SV_DS, s, c)
            oms.flush_all()
            oracle = QueryEngine(oms, SV_DS, mapper, device=dev)
            want = cl_prom(oracle.query_range(SV_QUERIES[0], *SV_RANGE[:2],
                                              SV_STEP))
            times = []
            launched = []
            for _ in range(1 + SV_SCALE_REPS):
                reset_k1(fg)
                t0 = time.perf_counter()
                body = sv_http(ep, SV_QUERIES[0])
                times.append((time.perf_counter() - t0) * 1000)
                launched.append(fg.fused_grid_kernel.launches)
                assert body["data"] == want, "scale answer differs"
            if on_card:
                assert launched == [SV_SHARDS] * len(launched), launched
                out["mem_allocated"] = torch.cuda.memory_allocated()
                out["mem_reserved"] = torch.cuda.memory_reserved()
                # K1's passes of one query by CUDA events, then the card's
                # busy share of SV_SCALE_REPS traced queries' host wall
                pairs: list = []
                reset_k1(fg)
                with sv_k1_events(torch, fg, pairs):
                    body = sv_http(ep, SV_QUERIES[0])
                torch.cuda.synchronize()
                assert body["data"] == want, "scale answer differs (timed)"
                launched.append(fg.fused_grid_kernel.launches)
                out["k1_ms"] = [s.elapsed_time(e) for s, e in pairs]
                assert len(out["k1_ms"]) == SV_SHARDS, out["k1_ms"]
                reset_k1(fg)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(SV_SCALE_REPS):
                        body = sv_http(ep, SV_QUERIES[0])
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                assert body["data"] == want, "scale answer differs (traced)"
                launched.append(fg.fused_grid_kernel.launches)
                assert launched[-1] == SV_SHARDS * SV_SCALE_REPS, launched
                out["query_device_ms"] = (sv_device_ms(torch, prof)
                                          / SV_SCALE_REPS)
                k1_rows = [e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and "fused_grid_map" in e.key]
                n_k1 = sum(e.count for e in k1_rows)
                out["k1_trace_ms"] = (sum(e.self_device_time_total
                                          for e in k1_rows) / 1e3
                                      / max(n_k1, 1))
                out["k1_trace_n"] = n_k1
                out["query_busy"] = (out["query_device_ms"] * SV_SCALE_REPS
                                     / wall_ms)
            out["k1"] = sum(launched)
            out["first_ms"] = times[0]
            out["p50_ms"] = float(np.percentile(times[1:], 50))
            out["series"] = sum(sh.num_series
                                for sh in srv.memstore.shards_of(SV_DS))
            assert out["series"] == n_series, out["series"]
        finally:
            for b in buses.values():
                b.close()
            for s in servers:
                s.shutdown()
            for n in nodes:
                with contextlib.suppress(Exception):
                    n.stop()
    out["seconds"] = time.perf_counter() - t_all
    log(f"server scale [{card}]: {n_series} SyntheticStream counters x "
        f"{SV_SAMPLES} samples ({rows} rows) over {SV_SHARDS} partitions "
        f"(replication 2, min_insync 2) into a FiloServer on {dev}: "
        f"containers built in {build_s:.2f} s; publish {out['publish_s']:.2f}"
        f" s ({out['publish_rows_s']:.0f} rows/s), ingest "
        f"{out['ingest_rows_s']:.0f} rows/s (first publish to every shard "
        f"consumed), every sample queryable {out['visible_after_s']:.3f} s "
        f"after the last publish; sum(rate(m[5m])) over HTTP: first "
        f"{out['first_ms']:.3f} ms, p50 {out['p50_ms']:.3f} ms over "
        f"{SV_SCALE_REPS}, K1 {SV_SHARDS} a query, bit for bit the direct "
        f"memstore; card memory allocated {out.get('mem_allocated', 0)} B, "
        f"reserved {out.get('mem_reserved', 0)} B "
        f"({out['seconds']:.1f} s)")
    st = out["stages_s"]
    other = out["publish_s"] - st["encode"]
    log(f"server scale stages [{card}]: host s summed over threads: "
        f"containers built {build_s:.3f} (before the window); encode "
        f"{st['encode']:.3f} ({out['stages_n']['encode']} containers), "
        f"publish less encode {other:.3f} (the client's frames, the broker's "
        f"append and replication), decode {st['decode']:.3f} "
        f"({out['stages_n']['decode']}), shard ingest {st['ingest']:.3f} "
        f"({out['stages_n']['ingest']}); ingest window "
        f"{(t_cons - t_pub0):.3f} s")
    if "k1_ms" in out:
        log(f"server scale device [{card}]: ingest window device time "
            f"{out['ingest_device_ms']:.3f} ms, busy share "
            f"{out['ingest_busy']:.6f} (traced); sum(rate(m[5m])) over "
            f"HTTP: CUDA events around K1's {SV_SHARDS} passes "
            f"{[round(t, 4) for t in out['k1_ms']]} ms (sum "
            f"{sum(out['k1_ms']):.4f}; the stream idles between, so they "
            f"hold the pass's host launch work too); traced: K1 "
            f"{out['k1_trace_ms']:.4f} ms a launch ({out['k1_trace_n']} "
            f"launches), device time {out['query_device_ms']:.4f} ms a "
            f"query, busy share {out['query_busy']:.4f} of "
            f"{SV_SCALE_REPS} queries' host wall")
    return out


def phase_server_procs(card, dev="cuda") -> dict:
    """Phase 15c: entry.dryrun_multichip's step 5 on ``dev``: two FiloServer
    processes (python -m filodb_tpu_torch.cli serve), each owning one of
    two shards, over one port broker and a file registrar; both answer the
    spanning queries bit for bit as one memstore holding both shards."""
    from filodb_tpu_torch.entry import two_process_query_check
    r = two_process_query_check(dev)
    log(f"server procs [{card}]: two FiloServer processes (cli serve "
        f"--device {r['device']}) up and answering in {r['up_s']:.1f} s; "
        f"sum(rate), count and topk over HTTP on both nodes bit for bit "
        f"one memstore of both shards ({r['seconds']:.1f} s)")
    return r


def phase_server(torch, np, fg, card, pkg, dev="cuda") -> int:
    """Phase 15 (15a, 15b, 15c). Returns K1's launches on its main paths."""
    t0 = time.perf_counter()
    a = phase_server_small(torch, np, fg, pkg, dev)
    log(f"server small [{card}]: two broker nodes (4 partitions, "
        f"replication 2, min_insync 2, epoch fencing), a FiloServer on "
        f"{dev} with 4 shards, a data_dir sink and the gateway, a CPU "
        f"FiloServer beside it; {a['rows']} rows ({SV_SERIES} counters x "
        f"{SV_SAMPLES} through BrokerBus, {SV_GW_SERIES * SV_GW_SAMPLES} "
        f"Influx lines); {len(SV_QUERIES)} queries over HTTP bit for bit a "
        f"memstore fed the broker's containers directly, the CPU server "
        f"within rtol 1e-5 (max |diff| {a['max_cpu_diff']:.3g}); route "
        f"{a['route']}; K1 against its twin on the server's shard stores "
        f"max |diff| {a['k1_vs_twin']:.3g}; leader killed at partition 0 "
        f"and back in {a['failover_s']:.2f} s (client failovers "
        f"{a['failovers']}), audit: frames {a['frames']}, 0 lost, 0 "
        f"duplicated, the two logs identical; restart from the sink "
        f"{a['restart_s']:.2f} s; shard {SV_SHARDS - 1} moved live in "
        f"{a['rebalance_s']:.2f} s; every answer the same after each; K1 "
        f"launches {a['k1']} ({a['seconds']:.1f} s)")
    ch = a["churn"]
    log(f"server churn [{card}]: {SV_CHURN_SERIES} counters born at sample "
        f"{SV_CHURN_FROM} through the gateway ({ch['rows']} lines): the "
        f"sink-backed nodes within rtol 1e-5 of the sink-less memstore "
        f"(max |diff| {ch['max_diff']:.3g}); by query, per node "
        f"(rows_paged_in, fused_kernels, K1 launches): "
        + "; ".join(f"{q} " + str([(p['rows_paged_in'], p['fused_kernels'],
                                    p['k1']) for p in per])
                    for q, per in ch["queries"].items()))
    b = phase_server_scale(torch, np, fg, card, pkg, dev)
    phase_server_procs(card, dev)
    log(f"server: phase 15 done in {time.perf_counter() - t0:.1f} s")
    return a["k1"] + b["k1"]


# -- phase 16: Prometheus remote read/write and the rules subsystem -------

RU_SERIES = 64                  # 16a: counters of metric m (tenant "demo")
# a series' samples, RU_STEP_MS apart on whole seconds, ending near now: the
# rules' 1 s ticks and load's live samples land on the same grid, which K1's
# route needs (core/chunkstore.py::_track_grid: one base and interval a
# shard, no gap in a series)
RU_SAMPLES = 600
RU_STEP_MS = 1_000
RU_JOBS = 4
RU_REC = {"rec:m_rate": "sum(rate(m[5m]))",
          "rec:m_rate_by_job": "sum by (job) (rate(m[5m]))",
          # over the first rule's output (unfused: an instant selector)
          "rec:m_rate_x2": "2 * rec:m_rate"}
RU_ALERTS = {"LoadHigh": ("sum(rate(load[5s])) > 0.5", "3s"),
             "MUp": ("sum(rate(m[5m])) > 0", "0s")}
RU_FUSED = {"rec:m_rate": True, "rec:m_rate_by_job": True,
            "rec:m_rate_x2": False, "LoadHigh": True, "MUp": True}
RU_STREAM_TICKS = 6             # 16a: the stalled span re-evaluated
RW_SERIES = 1 << 15             # 16b(i): counters a remote-write client sends
RW_SAMPLES = 32                 # a series, 10 s apart
RW_PER_REQ = 2000               # Prometheus's max_samples_per_send
RW_THREADS = 4
RW_LIVE_ROUNDS = 2              # 16b(i) live: scrape rounds a series
RS_TICKS = 16                   # 16b(ii): rule ticks at 60 s
RS_TICK_MS = 60_000
RS_RULES = {"scale:rate_sum": "sum(rate(m[5m]))",
            "scale:rate_avg": "avg(rate(m[5m]))",
            "scale:rate_max": "max(rate(m[5m]))",
            "scale:sot_sum": "sum(sum_over_time(m[5m]))"}
RS_ALERT = ("ScaleRate", "sum(rate(m[5m])) > 0")
RR_SERIES = 1024                # 16b(iii): series a remote read returns
RR_HOSTS = r"h(\d|[1-9]\d|[1-9]\d\d|10[01]\d|102[0-3])"


def ru_sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def ru_post(ep, path, body, timeout=60):
    """POST ``body``; (status, headers, response bytes)."""
    import urllib.error
    import urllib.request
    rq = urllib.request.Request(f"http://{ep}{path}", data=body,
                                method="POST")
    try:
        with urllib.request.urlopen(rq, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def ru_write_body(np, series) -> bytes:
    """snappy(WriteRequest) of [(labels dict, ts array, values array)]
    through the port's codec (the bytes a Prometheus client sends)."""
    from filodb_tpu_torch.promql import remote_storage as pb
    from filodb_tpu_torch.utils import snappy
    req = pb.WriteRequest()
    for labels, ts, vals in series:
        s = req.timeseries.add()
        for k, v in labels.items():
            s.labels.add(name=k, value=v)
        s.samples.extend_arrays(np.asarray(ts, np.int64),
                                np.asarray(vals, np.float64))
    return snappy.compress(req.SerializeToString())


def ru_read(ep, matchers, start, end):
    """POST a ReadRequest of one query; (status, body bytes, the decoded
    ReadResponse or None)."""
    from filodb_tpu_torch.promql import remote_storage as pb
    from filodb_tpu_torch.utils import snappy
    req = pb.ReadRequest()
    q = req.queries.add()
    q.start_timestamp_ms, q.end_timestamp_ms = int(start), int(end)
    for t, k, v in matchers:
        q.matchers.add(type=t, name=k, value=v)
    code, _h, body = ru_post(ep, f"/promql/{SV_DS}/api/v1/read",
                             snappy.compress(req.SerializeToString()))
    resp = None
    if code == 200:
        resp = pb.ReadResponse()
        resp.ParseFromString(snappy.decompress(body))
    return code, body, resp


def ru_series_arrays(resp) -> dict:
    """{sorted label pairs: (ts, values)} of a ReadResponse's first
    result."""
    out = {}
    for s in resp.results[0].timeseries:
        key = tuple(sorted((lp.name, lp.value) for lp in s.labels))
        out[key] = s.samples.arrays()
    return out


def ru_same_samples(np, got: dict, want: dict, what) -> int:
    """Every series of ``want`` in ``got`` with the same timestamps and the
    same value bits (NaN payloads included). Returns the samples."""
    assert set(got) == set(want), (what, len(got), len(want))
    n = 0
    for k, (wt, wv) in want.items():
        gt, gv = got[k]
        assert np.array_equal(gt, wt), (what, k)
        assert np.array_equal(np.asarray(gv, np.float64).view(np.uint64),
                              np.asarray(wv, np.float64).view(np.uint64)), \
            (what, k)
        n += len(wt)
    return n


@contextlib.contextmanager
def ru_k1_attribution(fg, tls, launches: dict):
    """Attribute K1's launches to the rule evaluation the calling thread
    has tagged in ``tls.tag`` (ru_tag_evaluator): ``launches[tag]`` is
    what K1's own counter rose by inside that evaluation's fused passes.
    The passes run one at a time while this is on, so a pass's rise is its
    own; untagged passes (HTTP queries, the checks) add to
    ``launches[None]``."""
    real = fg.fused_grid_partials
    lock = threading.Lock()

    def counting(*a, **kw):
        tag = getattr(tls, "tag", None)
        with lock:
            before = fg.fused_grid_kernel.launches
            try:
                return real(*a, **kw)
            finally:
                launches[tag] = launches.get(tag, 0) \
                    + fg.fused_grid_kernel.launches - before

    fg.fused_grid_partials = counting
    try:
        yield
    finally:
        fg.fused_grid_partials = real


def ru_tag_evaluator(srv, tls, done: list, seq):
    """Wrap the server's rule evaluator: each evaluation runs tagged with
    (uid, eval_ts, the next number of ``seq``) in ``tls`` and, when it
    returns, (uid, eval_ts, that number, rows) lands in ``done``."""
    ev = srv.rules.evaluator
    real = ev.evaluate_rule

    def tagged(rule, eval_ts, interval_ms=None):
        tag = (rule.uid, int(eval_ts), next(seq))
        tls.tag = tag
        try:
            n = real(rule, eval_ts, interval_ms)
        finally:
            tls.tag = None
        done.append((*tag, n))
        return n

    ev.evaluate_rule = tagged


def ru_hook():
    """A local webhook receiver: (server, url, events list)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    events: list = []

    class Hook(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length")
                                       or 0))
            events.append(json.loads(body))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, fmt, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="ru-hook").start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/hook", events


def ru_rules_config(url):
    """rules.* of 16a: a recording group and an alert group at 1 s; a
    catch-up of up to 8 ticks, so that a restart leaves no gap in a
    derived series."""
    return {"groups": [
        {"name": "rec", "interval": "1s", "rules": [
            {"record": r, "expr": e} for r, e in RU_REC.items()]},
        {"name": "alerts", "interval": "1s", "rules": [
            {"alert": a, "expr": e, "for": f}
            for a, (e, f) in RU_ALERTS.items()]}],
        "webhook_url": url, "webhook_backoff": "50ms", "max_catchup": 8}


def ru_backfill(np, end_ms):
    """16a's remote-write data: RU_SERIES counters of m over RU_JOBS jobs,
    RU_SAMPLES samples RU_STEP_MS apart, the last one RU_STEP_MS before
    ``end_ms`` (a whole second), integer-valued (an f32 store holds them
    exactly), and one flat counter ``load`` over the same span."""
    rng = np.random.default_rng(16)
    ts = end_ms - RU_SAMPLES * RU_STEP_MS + np.arange(RU_SAMPLES) \
        * RU_STEP_MS
    out = []
    for i in range(RU_SERIES):
        inc = rng.integers(0, 50, RU_SAMPLES)
        out.append(({"__name__": "m", "job": f"job-{i % RU_JOBS}",
                     "instance": f"10.0.{i // 256}.{i % 256}:9100",
                     "_ws_": "demo", "_ns_": "App-0"}, ts,
                    np.cumsum(inc).astype(np.float64)))
    out.append(({"__name__": "load", "instance": "10.1.0.1:9100",
                 "_ws_": "demo", "_ns_": "App-0"}, ts,
                np.full(RU_SAMPLES, 7.0)))
    return out


def ru_audit_log(np, nodes, addrs) -> dict:
    """The broker pair's logs: per partition dense offsets, unique pub-ids,
    both nodes' journals and frames identical; every derived row (a
    container row carrying the rules label) keyed (labels, ts) with its
    value and count. Returns {"frames": {p: n}, "rows": {...}}."""
    from filodb_tpu_torch.core.schemas import Schemas
    from filodb_tpu_torch.ingest.broker import BrokerBus
    from filodb_tpu_torch.rules import RULE_LABEL
    out = {"frames": {}, "rows": {}}
    for p in range(SV_SHARDS):
        items = [n._journals[p].items() for n in nodes]
        assert items[0] == items[1], f"partition {p}: journals differ"
        offs = [o for o, _ in items[0]]
        ids = [i for _, i in items[0]]
        assert offs == list(range(len(offs))), f"partition {p}: gaps"
        assert len(set(ids)) == len(ids), f"partition {p}: duplicates"
        f0 = [f for _o, f in nodes[0]._parts[p].frames_from(0)]
        f1 = [f for _o, f in nodes[1]._parts[p].frames_from(0)]
        assert f0 == f1, f"partition {p}: logs differ"
        out["frames"][p] = len(offs)
        bus = BrokerBus(addrs, p)
        try:
            for _off, c in bus.consume(Schemas()):
                for j in range(len(c)):
                    labels = c.label_sets[int(c.part_idx[j])]
                    if RULE_LABEL not in labels:
                        continue
                    key = (json.dumps(sorted(labels.items())),
                           int(c.ts[j]))
                    v, n = out["rows"].get(key, (None, 0))
                    out["rows"][key] = (float(c.values[j]), n + 1)
        finally:
            bus.close()
    return out


def ru_instant(eng, q, ts) -> dict:
    """{sorted labels json: value} of an instant query on an engine."""
    res = eng.query_instant(q, int(ts))
    return {json.dumps(sorted(dict(k.labels).items())): float(v[-1])
            for k, _t, v in res.matrix.iter_series()}


def ru_derived_key(rule, labels: dict) -> str:
    """The derived row's labels for one output series of ``rule`` (as the
    evaluator builds them: the metric renamed, provenance, defaults)."""
    from filodb_tpu_torch.rules import RULE_LABEL
    d = dict(labels)
    d.pop("_metric_", None)
    d["_metric_"] = rule
    d[RULE_LABEL] = f"rec/{rule}"
    d.setdefault("_ws_", "default")
    d.setdefault("_ns_", "default")
    return json.dumps(sorted(d.items()))


def ru_stale_pair(np, dev) -> dict:
    """16a's f64 leg: a FiloServer on ``dev`` and one on the CPU, f64
    stores, direct ingest, a tenant quota of 2 series. A write of two
    series holding Prometheus's stale marker answers 204; a write of the
    two and a new one answers 429 with Retry-After and the two series'
    samples land; a remote read returns every written sample bit for bit
    (the stale marker's payload included), and the card server's body is
    the CPU server's, byte for byte."""
    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.standalone import FiloServer
    stale = np.frombuffer(bytes.fromhex("020000000000f07f"), np.float64)[0]
    ts0 = BASE_TS
    ts = ts0 + np.arange(8) * 10_000
    vals = np.arange(8, dtype=np.float64) * 0.1
    vals1 = vals + 1
    vals[5] = vals1[5] = stale
    lab = [{"__name__": "stale_m", "host": f"s{i}", "_ws_": "q",
            "_ns_": "App-0"} for i in range(3)]
    first = ru_write_body(np, [(lab[0], ts, vals), (lab[1], ts, vals1)])
    ts2 = ts0 + 80_000 + np.arange(2) * 10_000
    second = ru_write_body(np, [(lab[0], ts2, np.array([0.5, stale])),
                                (lab[1], ts2, np.array([1.5, 2.5])),
                                (lab[2], ts2, np.array([3.5, 4.5]))])
    want = {tuple(sorted(lab[0].items())): (
                np.concatenate([ts, ts2]),
                np.concatenate([vals, [0.5, stale]])),
            tuple(sorted(lab[1].items())): (
                np.concatenate([ts, ts2]),
                np.concatenate([vals1, [1.5, 2.5]]))}
    out = {"codes": {}, "bodies": {}}
    for d in (dev, "cpu"):
        srv = FiloServer(Config({
            "num_shards": 1, "http": {"port": 0},
            "index": {"max_series_per_tenant": 2,
                      "quota_retry_after": "5s"},
            "store": {"max_series_per_shard": 16, "samples_per_series": 64,
                      "flush_batch_size": 10**9, "dtype": "float64"}}),
            device=d).start()
        try:
            ep = f"127.0.0.1:{srv.http.port}"
            path = f"/promql/{SV_DS}/api/v1/write"
            c1 = ru_post(ep, path, first)
            c2 = ru_post(ep, path, second)
            assert c1[0] == 204, c1
            assert c2[0] == 429 and int(c2[1]["Retry-After"]) >= 5 \
                and json.loads(c2[2])["errorType"] == "too_many_series", c2
            code, body, resp = ru_read(ep, [(0, "__name__", "stale_m")],
                                       ts0, ts0 + 200_000)
            assert code == 200, code
            out["samples"] = ru_same_samples(np, ru_series_arrays(resp),
                                             want, f"stale pair {d}")
            out["codes"][d] = (c1[0], c2[0])
            out["bodies"][d] = body
        finally:
            srv.shutdown()
    assert out["bodies"][dev] == out["bodies"]["cpu"], \
        "stale pair: the card's ReadResponse differs from the CPU's"
    out["body_bytes"] = len(out["bodies"]["cpu"])
    return out


def phase_rules_small(torch, np, fg, pkg, dev="cuda") -> dict:
    """Phase 16a: remote write and read, and the rules subsystem, on a
    FiloServer on ``dev`` with 4 shards, a data_dir sink and rules.groups
    over phase 15's broker pair (replication 2, min_insync 2, epoch
    fencing), a CPU FiloServer on the same brokers (no rules), and a
    webhook receiver. RU_SERIES counters of m (and a flat counter load)
    come in by remote write, timestamped up to the wall clock: 204, a
    spoofed __rule__ label 422, a malformed body 400 (and the f64 leg's
    429 and stale marker, ru_stale_pair). Rule groups at 1 s: three
    recording rules (sum(rate), sum by (job) (rate), and 2 x the first
    rule's output) and two alerts (for: 3s over load's rate, zero-for over
    m's). Through the live window: a partition leader killed and brought
    back while rules publish; LoadHigh driven pending by load writes, the
    server restarted from its sink while it is pending, then firing with
    its first active_at, then resolved when load goes flat, with the
    webhook's events. Checks: every derived sample after the data landed
    bit for bit the card's own instant query of its rule at its eval_ts
    (the rule over a rule: bit for bit its expression at its eval_ts or at
    a tick before it, whose input had landed), the CPU server within rtol
    1e-5; every (rule, eval_ts) once in the broker log and every completed
    evaluation there; K1 once a shard leaf for each fused rule's
    evaluation (0 for the rule over a rule); rules.streaming's catch-up of
    a stalled span the same rows as the instant path; the remote read of
    m bit for bit the written samples and byte for byte the CPU server's
    body; K1 against its twin on the server's shard stores."""
    import tempfile

    from filodb_tpu_torch.core import filters as F
    from filodb_tpu_torch.ingest.faults import FaultPlan, FaultRule
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    from filodb_tpu_torch.rules import (DerivedSeriesPublisher, RULE_LABEL,
                                        RulesManager)
    from filodb_tpu_torch.standalone import FiloServer
    _sc, _ms, _rb, GAUGE, _qe = pkg
    t_all = time.perf_counter()
    out: dict = {"k1": 0}
    kill = FaultRule("append", "kill_server", partition=0,
                     at_offset=1 << 40)
    plan = FaultPlan([kill])
    servers: list = []
    hook, url, events = ru_hook()
    tls = threading.local()
    seq = itertools.count()
    done: list = []
    per_eval: dict = {}
    stop_load = threading.Event()
    with tempfile.TemporaryDirectory(prefix="filodb-rules-") as tmp, \
            ru_k1_attribution(fg, tls, per_eval):
        addrs, nodes, start_broker = sv_brokers(tmp, plan)
        try:
            out["stale"] = ru_stale_pair(np, dev)
            cfg = sv_config(addrs, data_dir=os.path.join(tmp, "data"),
                            rules=ru_rules_config(url),
                            store={"samples_per_series": 1024})
            reset_k1(fg)
            srv = FiloServer(cfg, device=dev).start()
            servers.append(srv)
            ru_tag_evaluator(srv, tls, done, seq)
            cpu = FiloServer(sv_config(addrs, store={
                "samples_per_series": 1024}), device="cpu").start()
            servers.append(cpu)
            ep, ep_cpu = (f"127.0.0.1:{srv.http.port}",
                          f"127.0.0.1:{cpu.http.port}")
            wpath = f"/promql/{SV_DS}/api/v1/write"
            now = int(time.time()) * 1000
            data = ru_backfill(np, now)
            t0 = time.perf_counter()
            for k in range(0, len(data), 16):
                code, _h, _b = ru_post(ep, wpath, ru_write_body(
                    np, data[k:k + 16]))
                assert code == 204, code
            spoof = ru_write_body(np, [({"__name__": "forged",
                                         RULE_LABEL: "rec/x"},
                                        [now], [1.0])])
            code, _h, body = ru_post(ep, wpath, spoof)
            assert code == 422 and b"reserved for recording-rule" in body, \
                (code, body)
            assert ru_post(ep, wpath, b"\x05\x00not-snappy")[0] == 400
            # the window [t - span, t] holds every sample and starts at the
            # first (an earlier start would page the sink-backed leaf)
            rows = RU_SERIES * RU_SAMPLES
            span_s = (RU_SAMPLES - 1) * RU_STEP_MS // 1000

            def landed(e):
                got = ru_instant(e, f"sum(count_over_time(m[{span_s}s]))",
                                 now - RU_STEP_MS)
                return got and list(got.values())[0] == rows
            sv_wait("written", lambda: landed(srv.engines[SV_DS])
                    and landed(cpu.engines[SV_DS]), 60, 0.05)
            out["write_s"] = time.perf_counter() - t0
            # the rows every check below reads are fixed from here on
            t_fixed = (int(time.time() * 1000) // 1000 + 1) * 1000
            # a fused rule launches K1 once a shard leaf holding its metric
            # (load, in the last write, may land after m)
            def holding():
                return {name: sum(1 for sh in srv.memstore.shards_of(SV_DS)
                                  if len(sh.part_ids_from_filters(
                                      [F.Equals("_metric_", name)], 0,
                                      1 << 62)))
                        for name in ("m", "load")}
            held = {"m": SV_SHARDS, "load": 1}
            sv_wait("load landed", lambda: holding() == held, 30, 0.02)
            sv_wait("rules past the data", lambda: srv.rules.state.watermark(
                "rec") >= t_fixed + 2000, 30, 0.05)

            # a partition leader dies while the rules publish: a partition
            # node 0 leads that the derived rows route to
            mapper = ShardMapper(SV_SHARDS, 2)
            pubr = DerivedSeriesPublisher(GAUGE, mapper, None)
            parts = sorted({pubr.route(dict(json.loads(k))) % SV_SHARDS
                            for k in [
                ru_derived_key("rec:m_rate_by_job", {"job": f"job-{j}"})
                for j in range(RU_JOBS)] + [
                ru_derived_key("rec:m_rate", {})]})
            part = next(p for p in parts if p % 2 == 0)
            kill.partition = part
            kill.at_offset = nodes[0]._parts[part].end_offset + 2
            t0 = time.perf_counter()
            sv_wait("kill", lambda: plan.fired, 60, 0.02)
            sv_wait("dead node down", lambda: nodes[0]._stopped
                    and nodes[0]._thread is None, 30, 0.02)
            start_broker(0)
            sv_wait("rejoin", lambda: all(
                nodes[0]._parts[p].end_offset == nodes[1]._parts[p].end_offset
                for p in range(SV_SHARDS)), 60, 0.05)
            out["failover_s"] = time.perf_counter() - t0
            out["kill_partition"] = part

            # load climbs (through the CPU server's writer: the card server
            # restarts below): LoadHigh goes pending. One sample a whole
            # second, none skipped, as the grid wants
            load_errs: list = []

            def drive_load():
                v = 7.0
                t = now
                while not stop_load.is_set():
                    if climb.is_set():
                        v += 1.0
                    code, _h, _b = ru_post(ep_cpu, wpath, ru_write_body(
                        np, [(data[-1][0], [t], [v])]))
                    if code != 204:
                        load_errs.append(code)
                    t += RU_STEP_MS
                    stop_load.wait(max(t / 1000.0 - time.time(), 0.0))
            climb = threading.Event()
            climb.set()
            loader = threading.Thread(target=drive_load, name="ru-load")
            loader.start()

            def load_state():
                for a in srv.rules.alerts.active_alerts():
                    if a["labels"]["alertname"] == "LoadHigh":
                        return a
                return None
            sv_wait("LoadHigh pending", lambda: load_state() is not None,
                    30, 0.02)
            pending = load_state()
            assert pending["state"] == "pending", pending
            active_at = pending["activeAt"]
            # restart from the sink while the timer runs
            t0 = time.perf_counter()
            srv.shutdown()
            servers.remove(srv)
            srv = FiloServer(cfg, device=dev).start()
            servers.append(srv)
            ru_tag_evaluator(srv, tls, done, seq)
            ep = f"127.0.0.1:{srv.http.port}"
            restored = load_state()
            assert restored is not None \
                and restored["activeAt"] == active_at, (restored, active_at)
            out["restart_s"] = time.perf_counter() - t0
            sv_wait("LoadHigh firing", lambda: (load_state() or {}).get(
                "state") == "firing", 30, 0.02)
            assert load_state()["activeAt"] == active_at
            climb.clear()           # load goes flat: the rate falls to 0
            sv_wait("LoadHigh resolved", lambda: any(
                e["event"] == "resolved" and e["rule"] == "alerts/LoadHigh"
                for e in list(events)), 30, 0.05)
            stop_load.set()
            loader.join()
            assert not load_errs, load_errs
            srv.rules.notifier.drain()
            evs = [(e["event"], e["rule"]) for e in events]
            assert ("firing", "alerts/MUp") in evs, evs
            lh = [e for e in events if e["rule"] == "alerts/LoadHigh"]
            assert [e["event"] for e in lh] == ["firing", "resolved"], lh
            assert lh[0]["active_at"] == int(active_at * 1000), lh
            out["events"] = evs
            rules_health = [r["health"] for g in
                            srv.rules.rules_payload()["groups"]
                            for r in g["rules"]]
            assert rules_health == ["ok"] * 5, rules_health

            # the rule threads stop here: the checks below read a quiet
            # server, and the streaming catch-up's launches are its own
            srv.rules.stop()
            # exactly-once: the broker log against the evaluations
            audit = ru_audit_log(np, nodes, addrs)
            out["frames"] = audit["frames"]
            dup = [k for k, (_v, n) in audit["rows"].items() if n != 1]
            assert not dup, f"derived rows landed twice: {dup[:4]}"
            logged = {(dict(json.loads(k))[RULE_LABEL], ts)
                      for k, ts in audit["rows"]}
            completed = {(uid, ts) for uid, ts, _q, n in done if n}
            assert completed <= logged, sorted(completed - logged)[:4]
            out["derived_rows"] = len(audit["rows"])
            out["evaluations"] = len(done)

            # K1 once a shard leaf for each fused rule's evaluation
            eng = srv.engines[SV_DS]
            want_k1 = {f"{g}/{r}": (held["load" if r == "LoadHigh" else "m"]
                                    if RU_FUSED[r] else 0)
                       for g, names in (("rec", RU_REC), ("alerts",
                                                          RU_ALERTS))
                       for r in names}
            for uid, n in want_k1.items():
                got = {per_eval.get((u, ts, q), 0) for u, ts, q, _n in done
                       if u == uid and ts >= t_fixed + 2000}
                assert got == {n}, (uid, got, n)
            out["k1_per_eval"] = want_k1
            # the kernels line counts the rule evaluations' launches; the
            # checks' queries (the data landed, K1's grid) apart
            out["k1_checks"] = per_eval.pop(None, 0)
            out["k1_rule_passes"] = sum(per_eval.values())
            out["k1"] = out["k1_rule_passes"]

            # every derived sample of the fixed window: bit for bit the
            # card's instant query of its rule at its eval_ts, the CPU
            # server within rtol 1e-5
            reset_k1(fg)
            by_ts: dict = {}
            for (key, ts), (v, _n) in audit["rows"].items():
                if ts >= t_fixed + 2000:
                    by_ts.setdefault(ts, {})[key] = v
            worst = 0.0
            lags: dict = {}
            ticks = sorted(by_ts)
            for ts in ticks:
                for rule, expr in RU_REC.items():
                    mine = {k: v for k, v in by_ts[ts].items()
                            if dict(json.loads(k))["_metric_"] == rule}
                    if not mine:
                        continue
                    if rule == "rec:m_rate_x2":
                        lag = None
                        for back in range(0, 11):
                            t2 = ts - back * 1000
                            q = {ru_derived_key(rule, dict(json.loads(k))):
                                 v for k, v in ru_instant(eng, expr,
                                                          t2).items()}
                            if q and q == mine:
                                lag = back
                                break
                        assert lag is not None, (rule, ts, mine)
                        lags[lag] = lags.get(lag, 0) + 1
                        continue
                    q = {ru_derived_key(rule, dict(json.loads(k))): v
                         for k, v in ru_instant(eng, expr, ts).items()}
                    assert q == mine, (rule, ts, q, mine)
                    qc = {ru_derived_key(rule, dict(json.loads(k))): v
                          for k, v in ru_instant(cpu.engines[SV_DS], expr,
                                                 ts).items()}
                    assert set(qc) == set(mine), (rule, ts)
                    for k, v in mine.items():
                        d = abs(qc[k] - v)
                        assert d <= 1e-5 * max(abs(v), 1e-30), (rule, ts, d)
                        worst = max(worst, d)
            assert len(ticks) >= 5, ticks
            out["checked_ticks"] = len(ticks)
            out["max_cpu_diff"] = worst
            out["x2_lags"] = lags
            out["k1_checks"] += fg.fused_grid_kernel.launches

            # rules.streaming: a stalled span's catch-up as one range query
            # a rule gives the instant path's rows
            group = [g for g in srv.rules.groups if g.name == "rec"]
            stream_ticks = [ticks[-1] - k * 1000
                            for k in range(RU_STREAM_TICKS)][::-1]
            assert stream_ticks[0] >= t_fixed + 2000, stream_ticks
            rows_by_mode = {}
            k1_by_mode = {}
            for streaming in (False, True):
                captured: list = []

                def capture(shard, container, pub_id):
                    for j in range(len(container)):
                        labels = container.label_sets[
                            int(container.part_idx[j])]
                        captured.append((json.dumps(sorted(labels.items())),
                                         int(container.ts[j]),
                                         float(container.values[j]), pub_id))
                mgr = RulesManager(
                    group, eng, publisher=DerivedSeriesPublisher(
                        GAUGE, mapper, capture), dataset=SV_DS,
                    max_catchup=RU_STREAM_TICKS, streaming=streaming)
                mgr.state.set_watermark("rec", stream_ticks[0] - 1000)
                pend = mgr.scheduler.pending_ticks(group[0],
                                                   stream_ticks[-1] + 500)
                assert pend == stream_ticks, (pend, stream_ticks)
                reset_k1(fg)
                mgr.evaluator.prefetch(group[0], pend)
                assert all(mgr.scheduler.run_group_once(group[0], t)
                           for t in pend)
                k1_by_mode[streaming] = fg.fused_grid_kernel.launches
                out["k1"] += k1_by_mode[streaming]
                rows_by_mode[streaming] = sorted(captured)
            assert rows_by_mode[True] == rows_by_mode[False], \
                "streaming catch-up differs from the instant path"
            # the live ticks' rows in the log (the rule over a rule aside:
            # live, it may have read its input a tick late)
            live_ts = {ts for _k, ts in audit["rows"] if ts in stream_ticks}
            assert live_ts, stream_ticks
            live = sorted((k, ts, v) for (k, ts), (v, _n)
                          in audit["rows"].items()
                          if ts in live_ts and "rec:m_rate_x2" not in k)
            assert live == sorted((k, ts, v) for k, ts, v, _p
                                  in rows_by_mode[False]
                                  if ts in live_ts
                                  and "rec:m_rate_x2" not in k), \
                "the catch-up's rows differ from the live ticks'"
            out["stream_rows"] = len(rows_by_mode[True])
            out["stream_k1"] = k1_by_mode

            # remote read of m: the written samples bit for bit, the card's
            # body the CPU server's byte for byte
            want = {tuple(sorted(lab.items())): (ts, vals)
                    for lab, ts, vals in data if lab["__name__"] == "m"}
            bodies = []
            for e in (ep, ep_cpu):
                code, body, resp = ru_read(e, [(0, "__name__", "m")],
                                           now - 3_600_000, now - 1)
                assert code == 200, code
                out["read_samples"] = ru_same_samples(
                    np, ru_series_arrays(resp), want, f"read {e}")
                bodies.append(body)
            assert bodies[0] == bodies[1], "read body: card != CPU"
            out["read_bytes"] = len(bodies[0])

            # K1 against its twin on the server's own shard stores
            out["k1_vs_twin"] = sv_k1_vs_twin(
                torch, fg, srv, ep, dev, rng=(now - 240_000, now))
        finally:
            stop_load.set()
            for s in servers:
                s.shutdown()
            for n in nodes:
                with contextlib.suppress(Exception):
                    n.stop()
            hook.shutdown()
            hook.server_close()
    out["seconds"] = time.perf_counter() - t_all
    return out


def rw_labels() -> list:
    """16b(i)'s series: RW_SERIES counters, six labels each."""
    codes = ("200", "404", "500", "503")
    return [{"__name__": "http_requests_total", "job": f"api-{i % 32}",
             "instance": f"10.{i >> 16 & 255}.{i >> 8 & 255}.{i & 255}:9100",
             "code": codes[i % 4], "_ws_": "demo", "_ns_": f"App-{i % 16}"}
            for i in range(RW_SERIES)]


def rw_requests(np, labels, ts, vals, time_major: bool):
    """A remote-write client's bodies for the samples ``vals[i, k]`` at
    ``ts[k]``. As a Prometheus remote-write queue does, series are sharded
    over RW_THREADS senders (series i to sender i mod RW_THREADS) and each
    sender cuts its stream of samples into WriteRequests of RW_PER_REQ
    samples. ``time_major``: the stream goes round by round, so a request
    holds RW_PER_REQ series with one sample each (a queue that keeps up
    with its scrapes: Prometheus's live traffic). Otherwise series by
    series, a series' samples together and a series possibly continued in
    the sender's next request (a backfill: a queue catching up after an
    outage, or a bulk import). Returns (bodies by sender, the encode
    seconds)."""
    t0 = time.perf_counter()
    rounds = len(ts)
    bodies: list = [[] for _ in range(RW_THREADS)]
    for j in range(RW_THREADS):
        mine = range(j, RW_SERIES, RW_THREADS)
        runs = ([(i, k, k + 1) for k in range(rounds) for i in mine]
                if time_major else [(i, 0, rounds) for i in mine])
        cur: list = []
        n = 0
        for i, k, stop in runs:
            while k < stop:
                take = min(stop - k, RW_PER_REQ - n)
                cur.append((labels[i], ts[k:k + take], vals[i, k:k + take]))
                n += take
                k += take
                if n == RW_PER_REQ:
                    bodies[j].append(ru_write_body(np, cur))
                    cur, n = [], 0
        if cur:
            bodies[j].append(ru_write_body(np, cur))
    return bodies, time.perf_counter() - t0


@contextlib.contextmanager
def rw_stage_clocks(acc: dict):
    """Host CPU seconds (the calling thread's, time.thread_time: a wait for
    the interpreter lock is not counted), summed over threads, of the
    remote-write path's stages: snappy's decompress, the WriteRequest's
    decode, the whole of write_governed (whose rest is the containers'
    build) and the shard's ingest."""
    from filodb_tpu_torch.core.memstore import TimeSeriesShard
    from filodb_tpu_torch.promql import remote
    from filodb_tpu_torch.promql import remote_storage as pb
    from filodb_tpu_torch.utils import snappy
    for k in ("decompress", "decode", "governed", "ingest"):
        acc[k] = []
    saved = [(snappy, "decompress", snappy.decompress, "decompress"),
             (pb.WriteRequest, "ParseFromString",
              pb.WriteRequest.ParseFromString, "decode"),
             (remote, "write_governed", remote.write_governed, "governed"),
             (TimeSeriesShard, "ingest", TimeSeriesShard.ingest, "ingest")]

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.thread_time()
            try:
                return fn(*a, **kw)
            finally:
                acc[key].append(time.thread_time() - t0)
        return run

    for owner, name, fn, key in saved:
        setattr(owner, name, timed(fn, key))
    try:
        yield
    finally:
        for owner, name, fn, _key in saved:
            setattr(owner, name, fn)


def rw_window(port: int, bodies: list) -> dict:
    """POST each sender's bodies in order from a client thread of its own,
    one connection a sender, every answer 204. Returns the window (first
    POST to the last 204), the time of the last 204 and the server's
    stages' host CPU seconds summed over threads (rw_stage_clocks)."""
    import http.client
    path = f"/promql/{SV_DS}/api/v1/write"
    codes: list = []
    last: list = []

    def send(mine):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for body in mine:
                conn.request("POST", path, body=body)
                r = conn.getresponse()
                r.read()
                codes.append(r.status)
            last.append(time.perf_counter())
        finally:
            conn.close()

    stages: dict = {}
    with rw_stage_clocks(stages):
        threads = [threading.Thread(target=send, args=(b,),
                                    name=f"rw-client-{j}")
                   for j, b in enumerate(bodies)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    n_req = sum(len(b) for b in bodies)
    assert codes == [204] * n_req, sorted(set(codes))
    st = {k: sum(v) for k, v in stages.items()}
    return {"window_s": max(last) - t0, "t_last": max(last), "stages_s": {
        "decompress": st["decompress"], "decode": st["decode"],
        "build": st["governed"] - st["decompress"] - st["decode"],
        "ingest": st["ingest"]}}


def phase_rules_write_scale(torch, np, fg, card, dev="cuda") -> dict:
    """Phase 16b(i): Prometheus remote write at a Prometheus user's size
    into a 4-shard FiloServer on ``dev`` with direct ingest: RW_SERIES
    counters (six labels a series) in RW_PER_REQ-sample WriteRequests from
    RW_THREADS client threads (rw_requests), in two cells one after the
    other on one server. "backfill": RW_SAMPLES samples a series, packed
    series by series (a series' samples together); it creates the series.
    "live": RW_LIVE_ROUNDS more scrape rounds of every series, packed
    round by round (one sample a series a request, Prometheus's live
    shape), appended to the series that exist. The bodies are encoded
    before each window (the client's work). Prints for each cell accepted
    samples/s (first POST to the last 204), the host CPU seconds of the
    server's stages summed over threads (snappy decompress, decode,
    container build, shard ingest), and the seconds from the last 204
    until every sample answers; sum(count_over_time) and the sum of the
    last values equal the written ones exactly. K1 runs only in those
    checks' queries (``k1_checks``): ingest launches no kernel."""
    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.standalone import FiloServer
    t_all = time.perf_counter()
    rounds = RW_SAMPLES + RW_LIVE_ROUNDS
    rng = np.random.default_rng(161)
    vals = np.cumsum(rng.integers(0, 20, (RW_SERIES, rounds)),
                     axis=1).astype(np.float64)
    ts = BASE_TS + np.arange(rounds, dtype=np.int64) * INTERVAL_MS
    labels = rw_labels()
    out: dict = {"cells": {}, "k1_checks": 0}
    srv = FiloServer(Config({
        "num_shards": SV_SHARDS, "spread": 2, "http": {"port": 0},
        "query": {"result_cache_size": 0, "negative_cache_size": 0,
                  "fragment_cache_size": 0},
        "store": {"max_series_per_shard": RW_SERIES // 2,
                  "samples_per_series": 64, "flush_batch_size": 10**9}}),
        device=dev).start()
    try:
        eng = srv.engines[SV_DS]
        for name, lo, hi, time_major in (
                ("backfill", 0, RW_SAMPLES, False),
                ("live", RW_SAMPLES, rounds, True)):
            bodies, enc_s = rw_requests(np, labels, ts[lo:hi],
                                        vals[:, lo:hi], time_major)
            cell = {"requests": sum(len(b) for b in bodies),
                    "body_bytes": sum(len(x) for b in bodies for x in b),
                    "encode_s": enc_s, "samples": RW_SERIES * (hi - lo)}
            cell.update(rw_window(srv.http.port, bodies))
            cell["samples_s"] = cell["samples"] / cell["window_s"]
            t_end = int(ts[hi - 1])
            win = hi * INTERVAL_MS // 1000
            reset_k1(fg)

            def all_visible(_t=t_end, _w=win, _n=RW_SERIES * hi):
                got = ru_instant(eng, "sum(count_over_time("
                                 f"http_requests_total[{_w}s]))", _t)
                return got and list(got.values())[0] == _n
            sv_wait(f"remote write visible ({name})", all_visible, 120, 0.01)
            cell["visible_after_s"] = time.perf_counter() - cell.pop("t_last")
            got = ru_instant(eng, "sum(http_requests_total)", t_end)
            assert list(got.values()) == [float(vals[:, hi - 1].sum())], got
            out["k1_checks"] += fg.fused_grid_kernel.launches
            out["cells"][name] = cell
        out["series"] = sum(sh.num_series
                            for sh in srv.memstore.shards_of(SV_DS))
        assert out["series"] == RW_SERIES, out["series"]
    finally:
        srv.shutdown()
    out["seconds"] = time.perf_counter() - t_all
    return out


def phase_rules_scale(torch, np, fg, card, engine, dev="cuda") -> dict:
    """Phase 16b(ii): a RulesManager at full width over phase 4's engine
    (2^20 series x 720 samples, f32 raw, one shard): recording rules
    RS_RULES and the alert RS_ALERT at 60 s, RS_TICKS ticks inside the
    store's range through run_group_once, once with rules.streaming off
    (every tick an instant query a rule: K1 once a fused rule) and once on
    (the catch-up prefetched as one range query a rule). The derived rows
    go to a sibling dataset a mode on the same memstore (phase 4's store is
    not touched) and must be bit for bit the same in both modes, in the
    rows published and in the sibling stores. Prints ms a tick, K1
    launches, and on the card the device ms a tick (CUDA events around the
    tick: the stream idles while the host works, so they hold the host's
    time too), K1's ms a pass (CUDA events around each pass), and from the
    instant mode run again under torch.profiler the device time a tick and
    the busy share."""
    from filodb_tpu_torch.core.memstore import StoreConfig
    from filodb_tpu_torch.core.schemas import GAUGE
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.rules import (DerivedSeriesPublisher, RulesManager,
                                        load_groups)
    ms = engine.memstore
    on_card = torch.device(dev).type == "cuda"
    eng = QueryEngine(ms, engine.dataset, device=dev)    # caches off
    groups = load_groups([{"name": "scale", "interval": "60s", "rules": [
        {"record": r, "expr": e} for r, e in RS_RULES.items()] + [
        {"alert": RS_ALERT[0], "expr": RS_ALERT[1]}]}], RS_TICK_MS)
    # on the group's 60 s grid (the scheduler's ticks), an hour into the
    # store's two
    first = -(-(BASE_TS + 3_600_000) // RS_TICK_MS) * RS_TICK_MS
    ticks = [first + k * RS_TICK_MS for k in range(RS_TICKS)]
    out: dict = {"k1": 0, "modes": {},
                 "series": sum(sh.num_series
                               for sh in ms.shards_of(engine.dataset))}
    rows: dict = {}
    stores: dict = {}
    for streaming in (False, True):
        sib = f"{engine.dataset}:rules_{'stream' if streaming else 'instant'}"
        ms.setup(sib, GAUGE, 0, StoreConfig(
            max_series_per_shard=64, samples_per_series=64,
            flush_batch_size=10**9, device=dev))
        captured: list = []

        def publish(shard_num, container, pub_id, _sib=sib, _cap=captured):
            for j in range(len(container)):
                labels = container.label_sets[int(container.part_idx[j])]
                _cap.append((json.dumps(sorted(labels.items())),
                             int(container.ts[j]),
                             float(container.values[j]), pub_id))
            ms.ingest(_sib, shard_num, container)

        mgr = RulesManager(groups, eng, publisher=DerivedSeriesPublisher(
            GAUGE, ShardMapper(1), publish, dataset=sib), dataset=sib,
            max_catchup=RS_TICKS, streaming=streaming)
        g = mgr.groups[0]
        mgr.state.set_watermark(g.name, ticks[0] - RS_TICK_MS)
        assert mgr.scheduler.pending_ticks(g, ticks[-1]) == ticks
        pairs: list = []
        ru_sync(torch, dev)
        reset_k1(fg)
        with sv_k1_events(torch, fg, pairs):
            ev = ([torch.cuda.Event(enable_timing=True)
                   for _ in range(RS_TICKS + 2)] if on_card else None)
            t0 = time.perf_counter()
            if ev:
                ev[0].record()
            mgr.evaluator.prefetch(g, ticks)
            if ev:
                ev[1].record()
            for k, t in enumerate(ticks):
                assert mgr.scheduler.run_group_once(g, t), t
                if ev:
                    ev[k + 2].record()
            ru_sync(torch, dev)
            wall = time.perf_counter() - t0
        launched = fg.fused_grid_kernel.launches
        out["k1"] += launched
        mode = {"ms_tick": wall * 1e3 / RS_TICKS, "k1": launched,
                "rows": len(captured)}
        if ev:
            mode["device_ms_tick"] = ev[0].elapsed_time(ev[-1]) / RS_TICKS
            mode["prefetch_device_ms"] = ev[0].elapsed_time(ev[1])
            mode["tick_device_ms"] = [ev[k + 1].elapsed_time(ev[k + 2])
                                      for k in range(RS_TICKS)]
            mode["k1_ms"] = [s.elapsed_time(e) for s, e in pairs]
        st = mgr.alerts.snapshot()[f"scale/{RS_ALERT[0]}"]
        assert [s["state"] for s in st.values()] == ["firing"], st
        assert all(s["active_at"] == ticks[0] for s in st.values()), st
        health = {r: s["health"] for r, s in mgr.evaluator.status.items()}
        assert set(health.values()) == {"ok"}, health
        ms.shard(sib, 0).flush()
        stores[streaming] = {
            json.dumps(sorted(lbl.items())): (t.tolist(), v.tolist())
            for lbl, t, v in QueryEngine(ms, sib, device=dev).raw_series(
                [], 0, 1 << 62)}
        rows[streaming] = sorted(captured)
        out["modes"]["stream" if streaming else "instant"] = mode
    if on_card:
        # the instant mode again under torch.profiler (device activity
        # only; the rows are dropped): the card's time a tick and its busy
        # share of the ticks' host wall
        from torch.profiler import ProfilerActivity, profile
        mgr = RulesManager(groups, eng, publisher=DerivedSeriesPublisher(
            GAUGE, ShardMapper(1), lambda *_a: None), max_catchup=RS_TICKS)
        g = mgr.groups[0]
        reset_k1(fg)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in ticks:
                assert mgr.scheduler.run_group_once(g, t), t
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["k1"] += fg.fused_grid_kernel.launches
        dev_ms = sv_device_ms(torch, prof)
        k1_rows = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "fused_grid_map" in e.key]
        n_k1 = sum(e.count for e in k1_rows)
        out["traced"] = {
            "device_ms_tick": dev_ms / RS_TICKS, "busy": dev_ms / wall_ms,
            "ms_tick": wall_ms / RS_TICKS, "k1_n": n_k1,
            "k1_ms": sum(e.self_device_time_total for e in k1_rows) / 1e3
            / max(n_k1, 1)}
    assert rows[False] == rows[True], "streaming rows differ from instant"
    assert len(rows[False]) == len(RS_RULES) * RS_TICKS, len(rows[False])
    assert stores[False] == stores[True], "sibling stores differ"
    assert all(len(t) == RS_TICKS for t, _v in stores[False].values())
    out["values"] = {dict(json.loads(k))["_metric_"]: v[-1]
                     for k, (_t, v) in stores[False].items()}
    return out


def phase_rules_read_scale(torch, np, fg, card, engine, shard,
                           dev="cuda") -> dict:
    """Phase 16b(iii): a remote read of RR_SERIES series x 720 samples from
    phase 4's store over HTTP (__name__="m", host=~RR_HOSTS): the
    samples bit for bit the store's rows; prints the POST's ms, the body's
    bytes and samples/s, and the client's decode ms."""
    from filodb_tpu_torch.core import filters as F
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.promql import remote_storage as pb
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.utils import snappy
    eng = QueryEngine(engine.memstore, engine.dataset, device=dev)
    end = BASE_TS + (NUM_SAMPLES - 1) * INTERVAL_MS
    req = pb.ReadRequest()
    q = req.queries.add()
    q.start_timestamp_ms, q.end_timestamp_ms = BASE_TS, end
    q.matchers.add(type=pb.LabelMatcher.EQ, name="__name__", value="m")
    q.matchers.add(type=pb.LabelMatcher.RE, name="host", value=RR_HOSTS)
    body = snappy.compress(req.SerializeToString())
    srv = FiloHttpServer({engine.dataset: eng}, port=0).start()
    try:
        ep = f"127.0.0.1:{srv.port}"
        t0 = time.perf_counter()
        code, _h, got = ru_post(ep, f"/promql/{engine.dataset}/api/v1/read",
                                body, timeout=600)
        post_s = time.perf_counter() - t0
        assert code == 200, code
    finally:
        srv.stop()
    t0 = time.perf_counter()
    resp = pb.ReadResponse()
    resp.ParseFromString(snappy.decompress(got))
    decode_s = time.perf_counter() - t0
    series = {dict((lp.name, lp.value) for lp in s.labels)["host"]:
              s.samples.arrays() for s in resp.results[0].timeseries}
    assert len(series) == RR_SERIES, len(series)
    pids = shard.part_ids_from_filters(
        [F.Equals("_metric_", "m"), F.EqualsRegex("host", RR_HOSTS)],
        BASE_TS, end)
    hosts = [shard.index.labels_of(int(p))["host"] for p in pids]
    rows = torch.from_numpy(np.asarray(pids, np.int64)).to(
        shard.store.val.device)
    ts_w = shard.store.ts.index_select(0, rows)[:, :NUM_SAMPLES].cpu().numpy()
    v_w = shard.store.val.index_select(0, rows)[:, :NUM_SAMPLES].double() \
        .cpu().numpy()
    for i, h in enumerate(hosts):
        gt, gv = series[h]
        assert np.array_equal(gt, ts_w[i]), h
        assert np.array_equal(gv.view(np.uint64), v_w[i].view(np.uint64)), h
    n = RR_SERIES * NUM_SAMPLES
    return {"series": len(series), "samples": n, "ms": post_s * 1e3,
            "body_bytes": len(got), "samples_s": n / post_s,
            "decode_ms": decode_s * 1e3}


def phase_rules_on_bench(torch, np, fg, card, engine, shard,
                         dev="cuda") -> dict:
    """Phase 16b(ii) and (iii), on phase 4's engine as bench.py builds it
    (run before phase 4: no phase has touched its store yet)."""
    t0 = time.perf_counter()
    r = phase_rules_scale(torch, np, fg, card, engine, dev)
    for name, m in r["modes"].items():
        dev_part = (f"; device {m['device_ms_tick']:.4f} ms a tick by CUDA "
                    f"events around the ticks (prefetch "
                    f"{m['prefetch_device_ms']:.4f} ms), K1 "
                    f"{[round(x, 4) for x in m['k1_ms'][:6]]} ms a pass"
                    if "device_ms_tick" in m else "")
        log(f"rules scale [{card}]: {len(RS_RULES)} recording rules and 1 "
            f"alert over {r['series']} series x {NUM_SAMPLES}, {RS_TICKS} "
            f"ticks at {RS_TICK_MS // 1000} s through run_group_once, "
            f"streaming {name}: {m['ms_tick']:.3f} ms a tick, K1 launches "
            f"{m['k1']} ({m['rows']} derived rows){dev_part}")
    log(f"rules scale [{card}]: the rows of both modes bit for bit the "
        f"same, in the published containers and in the two sibling "
        f"datasets; last values {r['values']}")
    if "traced" in r:
        tr = r["traced"]
        log(f"rules scale device [{card}]: the instant mode traced "
            f"(torch.profiler): {tr['ms_tick']:.3f} ms a tick, device time "
            f"{tr['device_ms_tick']:.4f} ms a tick, busy share "
            f"{tr['busy']:.4f} of the ticks' host wall; K1 "
            f"{tr['k1_ms']:.4f} ms a launch ({tr['k1_n']} launches)")
    rr = phase_rules_read_scale(torch, np, fg, card, engine, shard, dev)
    log(f"remote read scale [{card}]: {rr['series']} series x "
        f"{NUM_SAMPLES} samples of phase 4's store over HTTP in "
        f"{rr['ms']:.3f} ms, body "
        f"{rr['body_bytes']} B, {rr['samples_s']:.0f} samples/s; the "
        f"client's decompress and decode {rr['decode_ms']:.3f} ms; every "
        f"sample bit for bit the store's")
    r["read"] = rr
    r["seconds"] = time.perf_counter() - t0
    log(f"rules scale: 16b(ii) and (iii) done in {r['seconds']:.1f} s")
    return r


def phase_rules_server(torch, np, fg, card, pkg, dev="cuda") -> dict:
    """Phase 16a and 16b(i) (run after phase 15). Returns their results;
    ``k1`` is K1's launches on the rule path (16a's rule evaluations and
    streaming catch-ups; the checks' queries apart)."""
    t0 = time.perf_counter()
    a = phase_rules_small(torch, np, fg, pkg, dev)
    st = a["stale"]
    log(f"rules small [{card}]: a FiloServer on {dev} (4 shards, a sink, "
        f"rules.groups: {list(RU_REC)} at 1 s, alerts {list(RU_ALERTS)}) "
        f"and a CPU FiloServer over two broker nodes (replication 2, "
        f"min_insync 2, epoch fencing); remote write of {RU_SERIES} "
        f"counters x {RU_SAMPLES} and a load counter: 204, a spoofed "
        f"__rule__ 422, a malformed body 400, landed in both servers in "
        f"{a['write_s']:.2f} s; the f64 leg: 204, then 429 with "
        f"Retry-After and the kept series' samples landed, "
        f"{st['samples']} samples read back bit for bit with the stale "
        f"marker, body {st['body_bytes']} B equal to the CPU's; leader of "
        f"partition {a['kill_partition']} killed while the rules publish "
        f"and back in {a['failover_s']:.2f} s; LoadHigh pending, the "
        f"server restarted from its sink in {a['restart_s']:.2f} s with the "
        f"timer kept, then firing and resolved; webhook events "
        f"{a['events']}; audit: frames {a['frames']}, {a['derived_rows']} "
        f"derived rows each once, every one of {a['evaluations']} "
        f"completed evaluations in the log; {a['checked_ticks']} ticks' "
        f"derived samples bit for bit the card's instant queries (the rule "
        f"over a rule by lag in ticks {a['x2_lags']}), the CPU server "
        f"within rtol 1e-5 (max |diff| {a['max_cpu_diff']:.3g}); K1 a "
        f"rule evaluation {a['k1_per_eval']} ({a['k1_rule_passes']} rule "
        f"passes; the checks' queries {a['k1_checks']}); streaming catch-up of {RU_STREAM_TICKS} ticks: "
        f"{a['stream_rows']} rows the instant path's, K1 launches "
        f"(instant, streaming) {tuple(a['stream_k1'].values())}; remote "
        f"read {a['read_samples']} samples bit for bit, body "
        f"{a['read_bytes']} B equal to the CPU's; K1 against its twin on "
        f"the server's stores max |diff| {a['k1_vs_twin']:.3g}; K1 launches "
        f"of the rule path {a['k1']} ({a['seconds']:.1f} s)")
    w = phase_rules_write_scale(torch, np, fg, card, dev)
    for name, c in w["cells"].items():
        s = c["stages_s"]
        shape = ("one sample a series a request, appended to the series "
                 "that exist: Prometheus's live shape" if name == "live"
                 else "a series' samples together, creating the series: a "
                 "backfill's shape")
        log(f"remote write scale [{card}] {name}: {RW_SERIES} counters x "
            f"{c['samples'] // RW_SERIES} samples ({c['samples']} samples, "
            f"six labels a series; {shape}) as {c['requests']} "
            f"WriteRequests of up to {RW_PER_REQ} samples ({c['body_bytes']}"
            f" B, encoded in {c['encode_s']:.2f} s before the window) from "
            f"{RW_THREADS} client threads into a 4-shard FiloServer on "
            f"{dev}: {c['window_s']:.3f} s, {c['samples_s']:.0f} samples/s "
            f"accepted; host CPU s summed over threads: snappy decompress "
            f"{s['decompress']:.3f}, decode {s['decode']:.3f}, container "
            f"build {s['build']:.3f}, shard ingest {s['ingest']:.3f}; every "
            f"sample answers {c['visible_after_s']:.3f} s after the last 204")
    log(f"remote write scale [{card}]: {w['series']} series; K1 launches "
        f"of the checks' queries {w['k1_checks']} (ingest launches none; "
        f"not in the kernels line) ({w['seconds']:.1f} s)")
    out = {"small": a, "write": w, "k1": a["k1"],
           "seconds": time.perf_counter() - t0}
    log(f"rules: 16a and 16b(i) done in {out['seconds']:.1f} s")
    return out


LK_THREADS = 8
LK_QUERIES = 16                 # a thread


def hist_quantile(h, before, q: float) -> float:
    """The q-quantile of the observations a Histogram took since
    ``before`` (its bucket counts then), interpolated within the buckets
    as histogram_quantile does."""
    counts = [b - a for a, b in zip(before, h.buckets)]
    total = sum(counts)
    rank, cum, lo = q * total, 0, 0.0
    for bound, c in zip(list(h.bounds) + [float("inf")], counts):
        if c and cum + c >= rank:
            if bound == float("inf"):
                return lo
            return lo + (bound - lo) * (rank - cum) / c
        cum += c
        lo = bound
    return float("nan")


def phase_locks(torch, np, fg, card, engine, shard) -> dict:
    """Phase 17: the lock round on the card (see the module docstring).
    Returns K1 raw's launches in the round (the serial checks apart) and
    what it printed."""
    import urllib.request

    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.utils import diagnostics, metrics
    t0 = time.perf_counter()
    variants = range_variants(shard)
    q = "sum(rate(m[5m]))"
    # the serial answers, one a range: the checks' K1 launches, apart
    reset_k1(fg)
    serial = [np.asarray(engine.query_range(q, s, e, STEP_MS).matrix.values)
              for s, e in variants]
    k1_serial = fg.fused_grid_kernel.launches
    for v in serial:
        assert v.shape[0] == 1 and np.isfinite(v).all(), v.shape
    lock = shard.lock
    hist = metrics.registry.histogram(metrics.FILODB_LOCK_HOLD_MS,
                                      {"class": "shard"})
    was = (diagnostics.enabled, diagnostics.lock_debug)
    answers, errors = {}, []
    start = threading.Barrier(LK_THREADS)

    def worker(t):
        try:
            start.wait(30)
            for i in range(LK_QUERIES):
                k = (t + i) % len(variants)
                s, e = variants[k]
                r = engine.query_range(q, s, e, STEP_MS)
                answers[(t, i)] = (k, np.asarray(r.matrix.values))
        except BaseException as exc:   # noqa: BLE001 — reported below
            errors.append(exc)

    diagnostics.enable(True)
    diagnostics.enable_lock_debug(True)
    try:
        c0, l0, h0 = lock.contentions, lock.long_holds, list(hist.buckets)
        n0 = hist.count
        reset_k1(fg)
        threads = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in range(LK_THREADS)]
        t_round = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        round_s = time.perf_counter() - t_round
        k1 = fg.fused_grid_kernel.launches
        k1_raw = fg.fused_grid_kernel.launches_by_kind["raw"]
        contentions = lock.contentions - c0
        long_holds = lock.long_holds - l0
        holds = hist.count - n0
        p50 = hist_quantile(hist, h0, 0.5)
        p99 = hist_quantile(hist, h0, 0.99)
    finally:
        diagnostics.enable(was[0])
        diagnostics.enable_lock_debug(was[1])
    assert not any(th.is_alive() for th in threads), "a query thread hung"
    assert not errors, errors
    n = LK_THREADS * LK_QUERIES
    assert len(answers) == n, len(answers)
    for (t, i), (k, v) in answers.items():
        assert v.tobytes() == serial[k].tobytes(), (t, i, k)
    assert k1 == k1_raw == n, (k1, k1_raw, n)
    # the node's scrape carries the lock's own counts
    srv = FiloHttpServer({"prometheus": engine}, port=0).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=60) as r:
            text = r.read().decode()
    finally:
        srv.stop()
    tags = '{dataset="prometheus",shard="0"}'
    for name, want in (("filodb_shard_lock_contentions", lock.contentions),
                       ("filodb_shard_lock_long_holds", lock.long_holds)):
        m = re.search(rf"^{name}{re.escape(tags)} (\S+)$", text, re.M)
        assert m and float(m.group(1)) == float(want), (name, want)
    out = {"k1": k1, "k1_serial": k1_serial, "answers": n,
           "round_s": round_s, "contentions": contentions,
           "long_holds": long_holds, "holds": holds, "hold_p50_ms": p50,
           "hold_p99_ms": p99, "seconds": time.perf_counter() - t0}
    log(f"locks [{card}]: {LK_THREADS} threads x {LK_QUERIES} "
        f"sum(rate(m[5m])) range queries over bench.py's {len(variants)} "
        f"ranges on bench.build_engine's store as built ({NUM_SERIES} raw "
        f"f32 series x {NUM_SAMPLES}, exponential(1) x 5 increments "
        f"cumulated, seed 7), diagnostics and lock debug on: {n} answers "
        f"bit for bit the serial ones, no DiagnosticsError, K1 raw "
        f"launches {k1} (the {k1_serial} serial checks apart) in "
        f"{round_s:.3f} s; shard lock contentions {contentions}, long "
        f"holds {long_holds} (over {diagnostics.HOLD_WARN_S} s); "
        f'filodb_lock_hold_ms{{class="shard"}} count {holds}, p50 '
        f"{p50:.4f} ms, p99 {p99:.4f} ms (interpolated in its buckets); "
        f"/metrics carries filodb_shard_lock_contentions and "
        f"filodb_shard_lock_long_holds at the lock's counts "
        f"({out['seconds']:.1f} s)")
    return out


# -- phase 18: three nodes, the downsample validator and the soaks ----------

TN_NODES = ("a", "b", "c")
# the grouped shapes' selector: 8 % of 11b's hosts (those whose id ends in
# 00-03 or 10-13), every grp value, on every shard. A grouped aggregate
# costs one Python group key a series (~5 s over all 2^20, ROADMAP queue
# 2), so over every series these shapes could not go through each node
TN_HOST_RE = "h.*[01][0-3]"
TN_SEL = f'{{host=~"{TN_HOST_RE}"}}'
# 18a: the reference three-node test's four shapes over 11b's metric and
# its grp label, M1, and two joins whose answers stay small for HTTP
TN_QUERIES = {
    "S1": "sum(rate(m[2m]))",
    "S2": f"avg by (grp) (m{TN_SEL})",
    "S3": "topk(3, m)",
    "S4": "count(m)",
    "M1": "sum(rate(m[5m]))",
    "J1": f"sum by (grp) (rate(m{TN_SEL}[5m])) / on(grp) "
          f"sum by (grp) (m{TN_SEL})",
    "J2": f"topk(5, rate(m{TN_SEL}[5m]) / on(grp) group_left "
          f"sum by (grp) (rate(m{TN_SEL}[5m])))",
}
TN_NARROW = ("S2", "J1", "J2")
TN_FUSED = ("S1", "M1")
# /exec POSTs a query: one a peer, and a join's two sides fan out apart
TN_JOINS = ("J1", "J2")
# the reference join test's fixture (tests/test_binary_join_cluster.py):
# 6 hosts, m{host, dc, job} two jobs a host and cap{host}, 120 samples at
# 10 s, 8 shards over three nodes
JN_HOSTS = 6
JN_QUERIES = (
    "sum by (host) (m) / on(host) cap",
    "sum by (host, dc) (m) / ignoring(dc) cap",
    "m / on(host) group_left cap",
    "cap * on(host) group_right m",
    "m / on(host) group_left() cap",
    "m > 300 and on(host) cap > 1000",
    "sum by (host) (m) or cap",
    "sum by (host) (m) unless on(host) cap",
    "sum by (host) (m) >= bool on(host) cap - 900",
)
# 18b: 4096 gauges at a 7 s cadence, offset 500 ms, for one hour
DV_SERIES = 4096
DV_CADENCE_MS = 7_000
DV_SAMPLES = 3_600_000 // DV_CADENCE_MS + 1
DV_BASE = 1_700_000_000_000
DV_CHUNK = 86                     # samples a container (~10 minutes)
DV_END = DV_BASE + 500 + (DV_SAMPLES - 1) * DV_CADENCE_MS
# 18c: each soak at the reference's defaults, durations cut to fit the
# phase's budget (PERF.md section 4)
SOAKS = {
    "ingestion_stress": {},
    "batch_ingestion": {},
    "churn_stress": {},
    "query_stress": {},
    "streaming_stress": {"duration_s": 10},
    "cluster_stress": {"duration_s": 15},
}
SOAK_K1 = ("query_stress", "streaming_stress", "cluster_stress")


def tn_manager(ds, nshards):
    from filodb_tpu_torch.parallel.cluster import ShardManager
    mgr = ShardManager()
    for n in TN_NODES:
        mgr.add_node(n)
    mgr.add_dataset(ds, nshards)
    return mgr


def tn_serve(pkg, dev, ds, memstores, mgr, nshards):
    """(engines, servers, endpoints): a node's engine and HTTP server over
    its memstore, peers resolved through the endpoints."""
    from filodb_tpu_torch.http.api import FiloHttpServer
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    QueryEngine = pkg[4]
    eps: dict = {}
    engines = {n: QueryEngine(memstores[n], ds, ShardMapper(nshards),
                              device=dev, cluster=mgr, node=n,
                              endpoint_resolver=eps.get)
               for n in TN_NODES}
    servers = {n: FiloHttpServer({ds: e}, port=0).start()
               for n, e in engines.items()}
    eps.update({n: f"127.0.0.1:{s.port}" for n, s in servers.items()})
    return engines, servers, eps


def tn_matched(name, selected) -> int:
    """Series a query's selectors match: a join has two; the grouped
    shapes match ``selected`` series a selector, the rest every series."""
    sides = 2 if name in TN_JOINS else 1
    return sides * (selected if name in TN_NARROW else NUM_SERIES)


def tn_owned(mgr, ds, shards, node):
    return [sh for sh in shards if mgr.node_of(ds, sh.shard_num) == node]


def tn_http(fg, eps, node, ds, q, s, e, owner=None) -> tuple:
    """One query through ``node`` over HTTP: (answer JSON, POSTs the node
    made, ms, K1 launches by node when ``owner`` attributes them)."""
    from filodb_tpu_torch.query import wire
    before = wire.breakers.total_requests()
    with k1_by_node(fg, owner or (lambda _v: "?")) as per:
        t0 = time.perf_counter()
        got = cl_http_query(eps[node], ds, q, s, e, STEP_MS)
        ms = (time.perf_counter() - t0) * 1000
    assert got["status"] == "success", got
    return got, wire.breakers.total_requests() - before, ms, dict(per)


def tn_trace(eps, ds, s, e) -> dict:
    """M1 through node a: one trace, serve spans from b and c, a leaf
    span for each of the 8 shards."""
    from filodb_tpu_torch.utils.tracing import (SPAN_QUERY, SPAN_QUERY_LEAF,
                                                SPAN_QUERY_SERVE, tracer)
    tracer.drain()
    cl_http_query(eps["a"], ds, TN_QUERIES["M1"], s, e, STEP_MS)
    spans = tracer.snapshot()
    roots = [sp for sp in spans if sp.name == SPAN_QUERY]
    assert len(roots) == 1, len(roots)
    members = [sp for sp in spans if sp.trace_id == roots[0].trace_id]
    serve = {sp.tags.get("node") for sp in members
             if sp.name == SPAN_QUERY_SERVE}
    leaves = {sp.tags.get("shard") for sp in members
              if sp.name == SPAN_QUERY_LEAF}
    assert serve == {"b", "c"}, serve
    assert leaves == set(range(MESH_SHARDS)), leaves
    return {"spans": len(members), "serve": sorted(serve)}


def tn_scale(torch, np, fg, pkg, shards, dev="cuda") -> dict:
    """18a's three nodes over phase 11b's 8 delta8 shards: every memstore
    adopts all 8 (no copy), the ShardManager deals them 3/3/2; every
    answer over HTTP bit for bit one node's host loop over the same
    shards, 2 POSTs a query (4 a join), K1 3/3/2 by node for the fused
    sum(rate); one trace across nodes; node c killed: one replan, its
    shards split over a and b, every answer through a and b as before
    (1 POST a query, 2 a join), K1 4/4."""
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    ds = "meshq"
    n = len(shards)
    mgr = tn_manager(ds, n)
    per_node = {node: tn_owned(mgr, ds, shards, node) for node in TN_NODES}
    assert sorted(len(v) for v in per_node.values()) == [2, 3, 3], per_node
    assert len(per_node["c"]) == 2
    engines, servers, eps = tn_serve(
        pkg, dev, ds, {node: adopt_shards(pkg, dev, ds, shards)
                       for node in TN_NODES}, mgr, n)
    host = pkg[4](adopt_shards(pkg, dev, ds, shards), ds, ShardMapper(n),
                  device=dev)
    s, e = range_variants(shards[0])[0]
    selected = sum(re.fullmatch(TN_HOST_RE, f"h{i}") is not None
                   for i in range(NUM_SERIES))
    k1_raw = k1_d8 = 0
    moved = {}
    out = {"ms": {}, "host_ms": {}, "k1": {}, "selected": selected}
    try:
        want, matched = {}, {}
        for name, q in TN_QUERIES.items():
            t0 = time.perf_counter()
            r = host.query_range(q, s, e, STEP_MS)
            want[name], matched[name] = cl_prom(r), r.stats.series_matched
            out["host_ms"][name] = (time.perf_counter() - t0) * 1000
            vals = np.asarray(r.matrix.values, np.float64)
            assert vals.size and np.isfinite(vals[~np.isnan(vals)]).all(), \
                name
        reset_k1(fg)
        for name, q in TN_QUERIES.items():
            for node in TN_NODES:
                got, posts, ms, per = tn_http(fg, eps, node, ds, q, s, e,
                                              by_store(per_node))
                assert got["data"] == want[name], (name, node,
                                                   "not bit-equal")
                assert posts == (4 if name in TN_JOINS else 2), \
                    (name, node, posts)
                assert got["stats"]["series_matched"] == matched[name] \
                    == tn_matched(name, selected), (name, matched[name])
                if name in TN_FUSED and torch.device(dev).type == "cuda":
                    assert per == {"a": 3, "b": 3, "c": 2}, (name, node, per)
                out["ms"][f"{name}@{node}"] = ms
                out["k1"][f"{name}@{node}"] = per
        out["trace"] = tn_trace(eps, ds, s, e)
        k1_raw += fg.fused_grid_kernel.launches_by_kind["raw"]
        k1_d8 += fg.fused_grid_kernel.launches_by_kind["delta8"]

        # kill c: its server stops, the monitor declares it dead at the
        # next dispatch (the resolver plays the monitor, as in the test)
        c_shards = sorted(sh.shard_num for sh in per_node["c"])
        servers["c"].stop()
        eps.pop("c")
        state = {"failed": False, "calls": 0}

        def resolver(node):
            if node == "c":
                state["calls"] += 1
                if not state["failed"]:
                    state["failed"] = True
                    mgr.remove_node("c")
                    return "127.0.0.1:1"      # nothing listens there
            return eps.get(node)

        engines["a"].endpoint_resolver = resolver
        reset_k1(fg)
        t0 = time.perf_counter()
        r = engines["a"].query_range(TN_QUERIES["M1"], s, e, STEP_MS)
        out["replan_ms"] = (time.perf_counter() - t0) * 1000
        assert state["failed"] and state["calls"] == 1, state
        assert r.exec_path == "local-replanned", r.exec_path
        assert cl_prom(r) == want["M1"], "replanned M1 not bit-equal"
        out["k1_replan"] = fg.fused_grid_kernel.launches
        moved = {sn: mgr.node_of(ds, sn) for sn in c_shards}
        assert set(moved.values()) == {"a", "b"}, moved
        survivors = {node: tn_owned(mgr, ds, shards, node)
                     for node in ("a", "b")}
        for name, q in TN_QUERIES.items():
            for node in ("a", "b"):
                got, posts, ms, per = tn_http(fg, eps, node, ds, q, s, e,
                                              by_store(survivors))
                assert got["data"] == want[name], (name, node, "after kill")
                assert posts == (2 if name in TN_JOINS else 1), \
                    (name, node, posts)
                if name in TN_FUSED and torch.device(dev).type == "cuda":
                    assert per == {"a": 4, "b": 4}, (name, node, per)
                out["ms"][f"{name}@{node} after"] = ms
                out["k1"][f"{name}@{node} after"] = per
        k1_raw += fg.fused_grid_kernel.launches_by_kind["raw"]
        k1_d8 += fg.fused_grid_kernel.launches_by_kind["delta8"]
    finally:
        for srv in servers.values():
            srv.stop()
    out["k1_raw"], out["k1_delta8"] = k1_raw, k1_d8
    out["moved"] = moved
    return out


def jn_cluster(np, pkg, dev):
    """(engines, oracle, servers): the reference join test's three nodes
    on ``dev``, each memstore holding every shard, and a one-node oracle."""
    from filodb_tpu_torch.parallel.shardmapper import ShardMapper
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    mgr = tn_manager(CL_DS, MESH_SHARDS)
    series = []
    for i in range(JN_HOSTS):
        for j in range(2):
            series.append(({"_metric_": "m", "host": f"h{i}",
                            "dc": f"dc{i % 2}", "job": f"j{j}"},
                           100.0 * (i + 1) + 7.0 * j))
        series.append(({"_metric_": "cap", "host": f"h{i}"},
                       1000.0 + 50.0 * i))
    t = np.arange(CL_N)
    ts = CL_START + t.astype(np.int64) * CL_IV
    stores = {}
    for node in (*TN_NODES, "oracle"):
        ms = TimeSeriesMemStore(device=dev)
        for sn in range(MESH_SHARDS):
            ms.setup(CL_DS, GAUGE, sn, StoreConfig(
                max_series_per_shard=32, samples_per_series=256,
                flush_batch_size=10**9, dtype="float64", device=dev))
        for idx, (labels, base) in enumerate(series):
            b = RecordBuilder(GAUGE)
            b.add_batch(labels, ts, base + 10.0 * np.sin(t / 9.0 + base))
            ms.ingest(CL_DS, idx % MESH_SHARDS, b.build())
        ms.flush_all()
        stores[node] = ms
    engines, servers, _eps = tn_serve(pkg, dev, CL_DS, stores, mgr,
                                      MESH_SHARDS)
    oracle = QueryEngine(stores["oracle"], CL_DS, ShardMapper(MESH_SHARDS),
                         device=dev)
    return engines, oracle, servers


def jn_list(np, pkg, devs=("cuda", "cpu")) -> dict:
    """The reference join test's whole list at that test's own size on
    three card nodes: every shape from every node bit for bit one card
    node, on the general join path, and within rtol 1e-5 of the CPU
    cluster's answer from the same node."""
    rng = CL_RANGE
    card, oracle, s_card = jn_cluster(np, pkg, devs[0])
    cpu, _o, s_cpu = jn_cluster(np, pkg, devs[1])
    n = 0
    try:
        for q in JN_QUERIES:
            want = cl_answer(np, oracle.query_range(q, *rng))
            for node in TN_NODES:
                g = card[node].query_range(q, *rng)
                assert g.exec_path == "local", (q, g.exec_path)
                assert cl_same(np, cl_answer(np, g), want), (q, node)
                compare_result(np, q, g, cpu[node].query_range(q, *rng),
                               False)
                n += 1
        many = card["a"].query_range("m / on(host) group_left cap", *rng)
        assert many.matrix.num_series == JN_HOSTS * 2
        q = "m / on(host) group_left cap"
        inst = card["c"].query_instant(q, CL_RANGE[1])
        assert cl_same(np, cl_answer(np, inst), cl_answer(
            np, oracle.query_instant(q, CL_RANGE[1])))
    finally:
        for srv in (*s_card.values(), *s_cpu.values()):
            srv.stop()
    return {"answers": n}


def dv_data(np, n_series, seed):
    """Each series' gauge values over the hour (f64, rounded to f32 so the
    raw store and the downsampler see the same numbers)."""
    rng = np.random.default_rng(seed)
    base = 50.0 + 10.0 * np.arange(n_series)[:, None] % 997
    return (base + rng.normal(0, 5, (n_series, DV_SAMPLES))).astype(
        np.float32).astype(np.float64)


def dv_containers(np, RecordBuilder, GAUGE, hosts, vals):
    """Containers of about ten minutes each, in time order."""
    ts = DV_BASE + 500 + np.arange(DV_SAMPLES, dtype=np.int64) * DV_CADENCE_MS
    out = []
    for c0 in range(0, DV_SAMPLES, DV_CHUNK):
        c1 = min(c0 + DV_CHUNK, DV_SAMPLES)
        b = RecordBuilder(GAUGE)
        for i, h in enumerate(hosts):
            b.add_batch({"_metric_": "m", "host": h}, ts[c0:c1],
                        vals[i, c0:c1])
        out.append(b.build())
    return out


def dv_wait_ingested(srv, n_series, samples, timeout_s=120.0):
    """Until the server's running shards hold every series and sample: a
    raw query answered before would sit, empty, in the negative cache."""
    def held():
        sh = [srv.memstore.shard("prometheus", s) for s in srv._running]
        return (sum(x.num_series for x in sh) == n_series
                and sum(int(x.store.stats.samples_appended) for x in sh)
                >= samples)
    sv_wait(f"{srv.node} ingested", held, timeout_s)


def dv_family_served(port, n_series, start) -> bool:
    """Does the node serve every series' 1 m bucket at the first and the
    last closed bucket end of the range (one cheap instant query each)?"""
    import urllib.parse
    import urllib.request
    for t in ((start // 60_000 + 1) * 60_000 - 1,
              (DV_END // 60_000) * 60_000 - 1):
        params = urllib.parse.urlencode({
            "query": "count(sum_over_time(m::dCount[59999ms]))",
            "time": t / 1000.0})
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/promql/prometheus:ds_1m/api/v1/"
                f"query?{params}", timeout=60) as r:
            res = json.load(r)["data"]["result"]
        if not res or float(res[0]["value"][1]) != n_series:
            return False
    return True


def dv_validate(port, n_series, start=DV_BASE) -> dict:
    """The port's validator against one node over [start, the last
    sample], once the node serves the family's first and last buckets:
    every column compared every series at every closed bucket. The
    report's ``k1_raw`` is K1's launches during the validator's own
    queries (the wait's probes apart)."""
    from filodb_tpu_torch.ops import fusedgrid as fg
    from filodb_tpu_torch.scripts import downsample_validator as dv
    sv_wait(f"the family on :{port}",
            lambda: dv_family_served(port, n_series, start), poll_s=0.25)
    buckets = DV_END // 60_000 - start // 60_000 - 1   # closed, interior
    k0 = fg.fused_grid_kernel.launches_by_kind["raw"]
    report = dv.validate(f"http://127.0.0.1:{port}", "prometheus", "1m",
                         "m", start, DV_END)
    report["k1_raw"] = fg.fused_grid_kernel.launches_by_kind["raw"] - k0
    assert report["ok"], report
    for col, c in report["checks"].items():
        assert c["series_raw"] == c["series_ds"] == n_series, (col, c)
        assert c["compared"] >= n_series * buckets, (col, c, buckets)
        assert c["mismatches"] == c["missing_ds_series"] \
            == c["missing_ds_points"] == 0, (col, c)
        assert c["max_rel_err"] <= 1e-6, (col, c)
    return report


def dv_one_node(np, pkg, tmp, dev="cuda") -> dict:
    """18b, one node: a FiloServer on the card with a data_dir and 1m
    downsampling over a FileBus, the hour published, the validator over
    HTTP."""
    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.ingest.bus import FileBus
    from filodb_tpu_torch.standalone import FiloServer
    RecordBuilder, GAUGE = pkg[2], pkg[3]
    srv = FiloServer(Config({
        "num_shards": 1, "data_dir": f"{tmp}/data", "bus_dir": f"{tmp}/bus",
        "http": {"port": 0},
        "downsample": {"enabled": True, "resolutions": ["1m"],
                       "serve_interval": "500ms"},
        "store": {"max_series_per_shard": DV_SERIES,
                  "samples_per_series": 1024, "flush_batch_size": 10**9,
                  "groups_per_shard": 1},
    }), device=dev).start()
    try:
        hosts = [f"h{i}" for i in range(DV_SERIES)]
        conts = dv_containers(np, RecordBuilder, GAUGE, hosts,
                              dv_data(np, DV_SERIES, 18))
        bus = FileBus(f"{tmp}/bus/shard0.log")
        t0 = time.perf_counter()
        for c in conts:
            bus.publish(c)
        dv_wait_ingested(srv, DV_SERIES, DV_SERIES * DV_SAMPLES)
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        report = dv_validate(srv.http.port, DV_SERIES)
        return {"ingest_s": ingest_s,
                "validate_s": time.perf_counter() - t0,
                "checked": report["checked"], "k1_raw": report["k1_raw"],
                "max_rel_err": max(c["max_rel_err"]
                                   for c in report["checks"].values())}
    finally:
        srv.shutdown()


def dv_two_nodes(np, pkg, tmp, dev="cuda") -> dict:
    """18b, two nodes: two FiloServers on the card over one broker, one
    registrar and one sink (a data_dir both write, each its own shards'),
    half the series a partition; the validator against each node's port
    sees all 4096 series, the peer's shard through cross-node dispatch."""
    from filodb_tpu_torch.config import Config
    from filodb_tpu_torch.ingest.broker import BrokerBus, BrokerServer
    from filodb_tpu_torch.standalone import FiloServer
    RecordBuilder, GAUGE = pkg[2], pkg[3]
    broker = BrokerServer(f"{tmp}/broker", num_partitions=2).start()
    servers, errors = {}, {}

    def starter(name):
        try:
            servers[name] = FiloServer(Config({
                "num_shards": 2, "bus_addr": f"127.0.0.1:{broker.port}",
                "data_dir": f"{tmp}/data",
                "http": {"port": 0},
                "cluster": {"registrar": f"{tmp}/members.jsonl",
                            "self_addr": name, "heartbeat_interval": "200ms",
                            "stale_after": "5s", "min_members": 2,
                            "join_timeout": "20s"},
                "downsample": {"enabled": True, "resolutions": ["1m"],
                               "serve_interval": "500ms"},
                "store": {"max_series_per_shard": DV_SERIES,
                          "samples_per_series": 1024,
                          "flush_batch_size": 10**9, "groups_per_shard": 1},
            }), device=dev).start()
        except Exception as e:  # noqa: BLE001 - asserted below
            errors[name] = e

    ths = [threading.Thread(target=starter, args=(nm,), daemon=True)
           for nm in ("node-a:1", "node-b:1")]
    try:
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not errors and len(servers) == 2, (errors, sorted(servers))
        half = DV_SERIES // 2
        vals = dv_data(np, DV_SERIES, 19)
        t0 = time.perf_counter()
        for s in (0, 1):
            bus = BrokerBus(f"127.0.0.1:{broker.port}", s)
            for c in dv_containers(np, RecordBuilder, GAUGE,
                                   [f"s{s}h{i}" for i in range(half)],
                                   vals[s * half:(s + 1) * half]):
                bus.publish(c)
            bus.close()
        for srv in servers.values():
            assert len(srv._running) == 1, (srv.node, srv._running)
            dv_wait_ingested(srv, half, half * DV_SAMPLES)
        ingest_s = time.perf_counter() - t0
        out = {"ingest_s": ingest_s}
        for name, srv in sorted(servers.items()):
            t0 = time.perf_counter()
            report = dv_validate(srv.http.port, DV_SERIES)
            out[name] = {"validate_s": time.perf_counter() - t0,
                         "checked": report["checked"],
                         "k1_raw": report["k1_raw"]}
        return out
    finally:
        for srv in servers.values():
            srv.shutdown()
        broker.stop()


def phase_soaks(torch, fg, card, dev="cuda") -> dict:
    """18c: each soak of filodb_tpu_torch.stress on the card at the
    reference's defaults (durations cut, SOAKS), in process; each passes
    its own checks; query, streaming and cluster launch K1 raw in their
    timed runs. A soak's report counts K1 over its timed run alone
    (``k1_raw_launches``, the main path's); K1's counts are also set to 0
    before each soak and read after it, and the difference is the
    launches of the soak's check queries (``k1_checks``)."""
    import importlib
    out = {}
    for name, kw in SOAKS.items():
        mod = importlib.import_module(f"filodb_tpu_torch.stress.{name}")
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        reset_k1(fg)
        t0 = time.perf_counter()
        rep = mod.main(**kw, device=dev)
        rep["wall_s"] = time.perf_counter() - t0
        rep.setdefault("k1_raw_launches", 0)
        rep["k1_checks"] = fg.fused_grid_kernel.launches_by_kind["raw"] \
            - rep["k1_raw_launches"]
        assert rep["ok"], (name, rep["checks"], rep)
        if name in SOAK_K1 and torch.device(dev).type == "cuda":
            assert rep["k1_raw_launches"] > 0, (name, rep)
        out[name] = rep
    i, b, c = (out[k] for k in ("ingestion_stress", "batch_ingestion",
                                "churn_stress"))
    q, s, cl = (out[k] for k in ("query_stress", "streaming_stress",
                                 "cluster_stress"))
    log(f"soaks [{card}]: ingestion_stress {i['n_series']} x "
        f"{i['n_samples']}: {i['samples_per_s']:.0f} samples/s "
        f"({i['seconds']:.3f} s, label hashes {i['prep_s']:.3f} s), "
        f"{i['series_created']} series, {i['exec_path']} sum(rate) finite")
    log(f"soaks [{card}]: batch_ingestion {b['n_series']} x "
        f"{b['n_samples']}: {b['samples_per_s']:.0f} samples/s to the "
        f"sink ({b['seconds']:.3f} s), batch downsample "
        f"{b['downsample_s']:.3f} s, recovery {b['recovery_s']:.3f} s of "
        f"{b['recovered']} samples, the recovered sum(rate) bit for bit")
    log(f"soaks [{card}]: churn_stress {c['rounds']} x "
        f"{c['series_per_round']}: {c['series_per_s']:.0f} series/s, "
        f"created {c['series_created']}, evicted {c['evicted']}, purged "
        f"{c['purged']}, live {c['live']} (peak {c['peak_live']}), arena "
        f"{c['arena_bytes']} B")
    log(f"soaks [{card}]: query_stress {q['n_series']} series, "
        f"{q['n_queries']} queries x {q['concurrency']} workers: "
        f"{q['queries_per_s']:.1f} queries/s, p50 {q['p50_ms']:.3f} ms, "
        f"p99 {q['p99_ms']:.3f} ms; every answer bit for bit its serial "
        f"one ({q['distinct_queries']} texts); K1 raw "
        f"{q['k1_raw_launches']}")
    log(f"soaks [{card}]: streaming_stress {s['duration_s']} s x "
        f"{s['n_series']} series: {s['rows_per_s']:.0f} rows/s "
        f"({s['ticks']} ticks), {s['queries_per_s']:.1f} queries/s, p50 "
        f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, retried "
        f"{s['retried']}, lock contentions {s['lock_contentions']}; "
        f"sum(rate) bit for bit a fresh store fed the same containers; "
        f"K1 raw {s['k1_raw_launches']}")
    log(f"soaks [{card}]: cluster_stress {cl['duration_s']} s at "
        f"{cl['target_rps']} records/s: {cl['rows_per_s']:.0f} rows/s, "
        f"{cl['queries_per_s']:.1f} queries/s, p50 {cl['p50_ms']:.3f} ms, "
        f"p99 {cl['p99_ms']:.3f} ms; takeover gap {cl['takeover_s']:.3f} "
        f"s, {cl['gap_errors']} errors in it, {cl['queries_after']} "
        f"queries after; K1 raw {cl['k1_raw_launches']}")
    log(f"soaks: wall s "
        f"{ {k: round(v['wall_s'], 1) for k, v in out.items()} }; K1 raw "
        f"in the timed runs "
        f"{ {k: v['k1_raw_launches'] for k, v in out.items()} }, in the "
        f"check queries { {k: v['k1_checks'] for k, v in out.items()} }")
    return out


def phase_three_node(torch, np, fg, card, pkg, shards, dev="cuda") -> dict:
    """Phase 18a (see the module docstring)."""
    t0 = time.perf_counter()
    r = tn_scale(torch, np, fg, pkg, shards, dev)
    jn = jn_list(np, pkg, (dev, "cpu"))
    ms = r["ms"]
    log(f"three nodes [{card}]: 11b's 8 delta8 shards dealt 3/3/2 "
        f"(c's {sorted(r['moved'])} to {r['moved']} after the kill); one "
        f"node's host loop ms "
        f"{ {k: round(v, 3) for k, v in r['host_ms'].items()} }; the "
        f"grouped shapes over {r['selected']} series ({TN_SEL})")
    for name, q in TN_QUERIES.items():
        got = {k.split('@')[1]: round(v, 3) for k, v in ms.items()
               if k.split('@')[0] == name}
        log(f"three nodes [{card}]: {name} {q}: over HTTP ms by node and "
            f"after the kill {got}; "
            f"{4 if name in TN_JOINS else 2} POSTs a query "
            f"({2 if name in TN_JOINS else 1} after the kill); bit for bit "
            f"the host loop"
            + (f"; K1 by node {r['k1'][name + '@a']}, after the kill "
               f"{r['k1'][name + '@a after']}" if name in TN_FUSED else ""))
    log(f"three nodes [{card}]: one trace of {r['trace']['spans']} spans, "
        f"serve spans from {r['trace']['serve']}; the replanned M1 "
        f"{r['replan_ms']:.3f} ms ({r['k1_replan']} K1 launches); the "
        f"join list ({len(JN_QUERIES)} shapes x 3 nodes = {jn['answers']} "
        f"answers) bit for bit one card node, within rtol 1e-5 of the CPU "
        f"cluster; K1 raw {r['k1_raw']}, delta8 {r['k1_delta8']} "
        f"({time.perf_counter() - t0:.1f} s)")
    return r


def phase_validator(np, fg, card, pkg, dev="cuda") -> dict:
    """Phase 18b (see the module docstring)."""
    import tempfile
    t0 = time.perf_counter()
    reset_k1(fg)
    with tempfile.TemporaryDirectory(prefix="filodb-dv-") as tmp:
        one = dv_one_node(np, pkg, tmp, dev)
    with tempfile.TemporaryDirectory(prefix="filodb-dv2-") as tmp:
        two = dv_two_nodes(np, pkg, tmp, dev)
    k1_all = fg.fused_grid_kernel.launches_by_kind["raw"]
    k1 = one["k1_raw"] + sum(v["k1_raw"] for k, v in two.items()
                             if k != "ingest_s")
    log(f"validator [{card}]: one node, {DV_SERIES} gauges x {DV_SAMPLES} "
        f"samples at 7 s through a FileBus, ingested in "
        f"{one['ingest_s']:.3f} s; the port's validator ok in "
        f"{one['validate_s']:.3f} s: {one['checked']} points compared, 0 "
        f"mismatches, 0 missing, max rel err {one['max_rel_err']:.3g}")
    log(f"validator [{card}]: two nodes on one broker, ingested in "
        f"{two['ingest_s']:.3f} s; ok over the hour against each node's "
        f"port "
        f"{ {k: v for k, v in two.items() if k != 'ingest_s'} }; K1 raw "
        f"{k1} in the validator's queries, {k1_all - k1} in the waits' "
        f"probes ({time.perf_counter() - t0:.1f} s)")
    return {"one": one, "two": two, "k1_raw": k1}


def phase_soak(torch, np, fg, card, pkg, shards, dev="cuda") -> dict:
    """Phase 18: 18a on ``shards`` (11b's, delta8-resident), 18b, 18c.
    Returns K1's launches by decode variant."""
    t0 = time.perf_counter()
    r18a = phase_three_node(torch, np, fg, card, pkg, shards, dev)
    t18b = time.perf_counter()
    r18b = phase_validator(np, fg, card, pkg, dev)
    t18c = time.perf_counter()
    r18c = phase_soaks(torch, fg, card, dev)
    k1 = r18a["k1_raw"] + r18b["k1_raw"] + sum(
        v["k1_raw_launches"] for v in r18c.values())
    log(f"soak: phase 18 done in {time.perf_counter() - t0:.1f} s (18a "
        f"{t18b - t0:.1f}, 18b {t18c - t18b:.1f}, 18c "
        f"{time.perf_counter() - t18c:.1f}); K1 raw {k1}, delta8 "
        f"{r18a['k1_delta8']}")
    return {"raw": k1, "delta8": r18a["k1_delta8"]}


# ---- phase 19: the benchmark suite's twin ---------------------------------

# also run at --full: the reference's jmh shapes
BS_FULL = ("query_hicard", "hist_query")
# suites whose main path must launch K1 raw, K1's decode variants, K2
BS_K1_RAW = ("query_hicard", "serving", "fused_resident", "mesh_query")
BS_K1_NARROW = {"scalar_residency": NARROW_KINDS}
BS_K2 = ("fused_resident", "hist_retention")
BS_OUT = os.path.join(HERE, "chiprun_out", "bench_suite_phase19.jsonl")


def phase_bench_suite(torch, np, fg, fr, card, dev="cuda") -> dict:
    """Phase 19 (see the module docstring). Returns the main-path launches
    of the whole phase: {"k1": {kind: n}, "k2": n, "seconds": s}."""
    import io
    from filodb_tpu_torch.scripts import bench_suite as bs
    mode0 = fr.mode()
    runs = [(n, False) for n in sorted(bs.SUITES)] + \
        [(n, True) for n in BS_FULL]
    k1_all = dict.fromkeys(fg.fused_grid_kernel.launches_by_kind, 0)
    k2_all = 0
    walls = {}
    t_all = time.perf_counter()
    os.makedirs(os.path.dirname(BS_OUT), exist_ok=True)
    with open(BS_OUT, "w") as jsonl:
        for name, full in runs:
            tag = f"{name} --full" if full else name
            gc.collect()
            torch.cuda.empty_cache()
            reset_k1(fg)
            fr.fused_hist_kernel.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rec = bs.SUITES[name](full, dev) or {}
            compare = rec.get("compare_launches", {"k1": 0, "k2": 0})
            walls[tag] = time.perf_counter() - t0
            lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
            got = [ln["metric"] for ln in lines]
            optional = {m for s, m in bs.OPTIONAL if s == name}
            want = [m for m in bs.declared_metrics(name, full)
                    if m in got or m not in optional]
            assert all(ln["suite"] == name for ln in lines), tag
            assert got == want, (tag, got, want)
            # the launches made only to hold a kernel against its plain
            # twin (fused_resident's parity rows: K1 raw, K2) are not the
            # suite's main path
            k1 = dict(fg.fused_grid_kernel.launches_by_kind)
            k1["raw"] -= compare["k1"]
            k2 = fr.fused_hist_kernel.launches - compare["k2"]
            assert sum(k1.values()) == fg.fused_grid_kernel.launches \
                - compare["k1"], (tag, k1)
            if name in BS_K1_RAW:
                assert k1["raw"] > 0, (tag, k1)
            for kind in BS_K1_NARROW.get(name, ()):
                assert k1[kind] > 0, (tag, kind, k1)
            if name in BS_K2:
                assert k2 > 0, (tag, k2)
            if name == "fused_resident":
                for shape, legs in rec["legs"].items():
                    off, fused = legs["off"], legs["fused"]
                    assert off["k1"] == off["k2"] == 0, (shape, off)
                    assert (fused["k2"] if shape == "hist_quantile"
                            else fused["k1"]) > 0, (shape, fused)
                    assert off["route"] == "local", (shape, off["route"])
                    o, f = off["values"], fused["values"]
                    assert np.array_equal(np.isnan(o), np.isnan(f)), shape
                    with np.errstate(all="ignore"):
                        rel = np.nanmax(np.abs(f - o) / np.maximum(
                            np.abs(o), 1e-12), initial=0.0)
                    assert rel <= 2e-5, (shape, rel)
                log(f"bench suite: fused_resident legs "
                    f"{ {s: {leg: (v['route'], v['k1'], v['k2'], v['queries']) for leg, v in legs.items()} for s, legs in rec['legs'].items()} } "
                    f"(route, K1, K2, queries)")
            for kind, v in k1.items():
                k1_all[kind] += v
            k2_all += k2
            for ln in lines:
                jsonl.write(json.dumps(dict(ln, full=full)) + "\n")
            log(f"bench suite: {tag} {walls[tag]:.1f} s, {len(lines)} "
                f"metrics; K1 by kind "
                f"{ {k: v for k, v in k1.items() if v} }, K2 {k2}")
    assert fr.mode() == mode0 == "pallas", (fr.mode(), mode0)
    seconds = time.perf_counter() - t_all
    log(f"bench suite [{card}]: {len(runs)} runs of "
        f"{len(bs.SUITES)} suites in {seconds:.1f} s; main-path launches "
        f"K1 {k1_all}, K2 {k2_all}; slowest "
        f"{sorted(walls.items(), key=lambda kv: -kv[1])[:5]}")
    return {"k1": k1_all, "k2": k2_all, "seconds": seconds}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2
    import numpy as np

    from filodb_tpu_torch import bench
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import GAUGE, PROM_HISTOGRAM
    from filodb_tpu_torch.ops import fusedgrid as fg
    from filodb_tpu_torch.ops import fusedresident as fr
    from filodb_tpu_torch.ops import kernels, narrow
    from filodb_tpu_torch.ops import streamprobe as sp
    from filodb_tpu_torch.query.engine import QueryEngine
    pkg = (StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine)
    hpkg = (StoreConfig, TimeSeriesMemStore, RecordBuilder, PROM_HISTOGRAM,
            QueryEngine)

    t_all = time.perf_counter()
    card = bench.card_line()
    if sys.argv[1:2] == ["--profile-hist"]:
        # not part of the smoke run: the profile behind PERF.md section 5
        kernels.build()
        named = [sys.argv[i + 1] for i, a in enumerate(sys.argv[:-1])
                 if a == "--query"]
        profile_hist(torch, np, fr, fg, card, hpkg, named)
        return 0
    if sys.argv[1:2] == ["--k2-parts"]:
        kernels.build(("fusedhist",))
        k2_parts(torch, np, fr, card, hpkg, sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--k2-compare"]:
        return 0 if k2_compare(torch, sys.argv[2:]) else 1
    if sys.argv[1:2] == ["--k1-narrow"]:
        # not part of the smoke run: K1's shape checks and the narrow scale
        # timings of the package in ROOT, to time two checkouts in turns
        kernels.build(("fusedgrid", "streamprobe"))
        log_build(kernels, fg, ("fusedgrid",))
        t0 = time.perf_counter()
        checks, exact, worst = phase_k1_shapes(torch, np, fg, narrow, "cuda")
        log(f"k1-narrow: {checks} launch-shape checks against the plain "
            f"twin (max |diff| {worst:.3g}), {exact} bit for bit K1 raw on "
            f"the decode ({time.perf_counter() - t0:.1f} s)")
        k3 = phase_stream_kernels(torch, np, sp, card, "cuda")
        engine, shard, reg_s = bench.build_engine("cuda", residency="gauge")
        k1n = {kind: phase_scale_narrow(torch, np, fg, card, shard, engine,
                                        kind) for kind in NARROW_KINDS}
        log(f"k1-narrow [{card}] {ROOT}: " + json.dumps({
            "k3_ms": k3["ms"], **{kind: {k: r[k] for k in (
                "ms", "raw_ms", "bound_ms", "max_abs_err", "panel_ms",
                "panel_raw_ms") if k in r}
                for kind, r in k1n.items()}}))
        return 0
    if sys.argv[1:2] == ["--durable"]:
        # not part of the smoke run: phases 13a and 13b alone
        kernels.build()
        k1a, k2a, n13a, codec = phase_durable_small(torch, np, fg, fr, pkg)
        log(f"durable small: {n13a} records match the CPU; codec {codec}; "
            f"K1 {k1a}; K2 {k2a}")
        t0 = time.perf_counter()
        phase_durable_scale(torch, np, fg, card, pkg)
        log(f"durable scale: done in {time.perf_counter() - t0:.1f} s")
        return 0
    if sys.argv[1:2] == ["--server"]:
        # not part of the smoke run: phase 15 alone
        kernels.build()
        phase_server(torch, np, fg, card, pkg)
        return 0
    if sys.argv[1:2] == ["--rules"]:
        # not part of the smoke run: phase 16 alone, 16b(ii)/(iii) on
        # phase 4's engine built here
        kernels.build()
        engine, shard, reg_s = bench.build_engine("cuda")
        log(f"rules: phase 4's engine registered in {reg_s:.1f} s")
        r16b = phase_rules_on_bench(torch, np, fg, card, engine, shard)
        del engine, shard
        gc.collect()
        torch.cuda.empty_cache()
        r16 = phase_rules_server(torch, np, fg, card, pkg)
        log(f"rules: phase 16 done in {r16b['seconds'] + r16['seconds']:.1f}"
            f" s; K1 launches {r16b['k1'] + r16['k1']}")
        return 0
    if sys.argv[1:2] == ["--locks"]:
        # not part of the smoke run: phase 17 alone, on phase 4's engine
        # built here
        kernels.build()
        engine, shard, reg_s = bench.build_engine("cuda")
        log(f"locks: phase 4's engine registered in {reg_s:.1f} s")
        phase_locks(torch, np, fg, card, engine, shard)
        return 0
    if sys.argv[1:2] == ["--soak"]:
        # not part of the smoke run: phase 18 alone, 18a on phase 11b's
        # shards built (and made delta8-resident) here
        kernels.build()
        _ms, shards, reg_s = build_mesh_scale(torch, np, pkg)
        comp_s = mesh_scale_delta8(torch, shards)
        log(f"soak: 11b's shards registered in {reg_s:.1f} s, delta8 in "
            f"{comp_s:.2f} s")
        phase_soak(torch, np, fg, card, pkg, shards)
        return 0
    if sys.argv[1:2] == ["--bench-suite"]:
        # not part of the smoke run: phase 19 alone
        kernels.build()
        phase_bench_suite(torch, np, fg, fr, card)
        return 0
    if sys.argv[1:2] == ["--cluster"]:
        # not part of the smoke run: phase 14 alone, on phase 11b's shards
        # built (and made delta8-resident) here
        kernels.build()
        phase_cluster_small(torch, np, fg, pkg)
        _ms, shards, reg_s = build_mesh_scale(torch, np, pkg)
        comp_s = mesh_scale_delta8(torch, shards)
        log(f"cluster: 11b's shards registered in {reg_s:.1f} s, delta8 in "
            f"{comp_s:.2f} s")
        phase_cluster_scale(torch, np, fg, card, pkg, shards)
        del _ms, shards
        gc.collect()
        torch.cuda.empty_cache()
        phase_cluster_procs(torch, np, fg, card, pkg)
        return 0
    log(f"build: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"build: {', '.join(built) or 'nothing stale'} in "
        f"{time.perf_counter() - t0:.1f} s")
    log_build(kernels, fg, list(kernels.build_log))

    t0 = time.perf_counter()
    checks, worst2 = phase_kernels(torch, np, fg, "cuda")
    log(f"kernels: fusedgrid_k1 ({checks} checks against the plain twin, "
        f"max |diff| {worst2:.3g}, {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    checks, exact, worst2n = phase_narrow_kernels(torch, np, fg, narrow,
                                                  "cuda")
    log(f"kernels: fusedgrid_k1 decode variants ({checks} checks against "
        f"the plain twin, max |diff| by kind {worst2n}; {exact} bit-exact "
        f"checks against K1 raw on the decoded block; delta8 at c0 > 0 and "
        f"delta16 at C = 1040 refused; {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    checks, exact, worst2s = phase_k1_shapes(torch, np, fg, narrow, "cuda")
    log(f"kernels: fusedgrid_k1 launch shapes ({checks} checks against the "
        f"plain twin at Tp = 256 and 512, leading dead steps, short last "
        f"tiles, the largest shared memory, a misaligned view, C = 1004 and "
        f"1001 and a view of each from row 1, C = 136, C = 1024 at c0 > 0; "
        f"max |diff| "
        f"{worst2s:.3g}; {exact} bit-exact checks against K1 raw on the "
        f"decoded block; {time.perf_counter() - t0:.1f} s)")
    rows, differ, ok_card, ok_cpu = phase_quant16_scale(torch, np, narrow,
                                                        "cuda")
    log(f"quant16 scale: {rows} rows with spans near 65535 * 2^k, k in "
        f"[-20, 20], encoded on the card and on the CPU: {differ} rows "
        f"differ in block, vmin, scale or ok ({ok_card} ok rows on the "
        f"card, {ok_cpu} on the CPU); every ok row decodes bit for bit")
    t0 = time.perf_counter()
    k3 = phase_stream_kernels(torch, np, sp, card, "cuda")
    log(f"stream: streamprobe_k3 ({k3['checks']} checks against the plain "
        f"twin, max |diff| {k3['max_abs_err']:.3g}; tail rows skipped; "
        f"scalar loads on a misaligned view; CPU, f16 and C = 64 refused; "
        f"{time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    launches, worst_e = phase_entry(torch, np, fg, "cuda")
    log(f"entry: entry() on the card matches the CPU (max |diff| "
        f"{worst_e:.3g}); K1 launches {launches}")

    t0 = time.perf_counter()
    small = phase_small(torch, np, fg, pkg)
    log(f"small: {len(SLICE_QUERIES)} queries on 4096 series match the CPU "
        f"engine; K1 launches {small} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    small_n = phase_small_narrow(torch, np, fg, pkg)
    log(f"small narrow: {len(SLICE_QUERIES)} queries x {len(NARROW_KINDS)} "
        f"kinds on 4096-series gauge stores match the CPU engine; K1 "
        f"launches by kind {small_n} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    n_q, launches8a, fused8a = phase_general_small(torch, np, fg, pkg)
    log(f"general small: {n_q} queries of the general mix on 1312 series "
        f"match the CPU engine; K1 launches {launches8a} = the fused routes "
        f"QueryStats counts ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    k1_12a, equal12a, n12a = phase_serving_small(torch, np, fg, pkg)
    log(f"serving small: {n12a} steps of the serving sequence (cold, "
        f"result-cache hit, shift, tail ingest + shift, release, typo, "
        f"negative hit) with every cache and admission on match the CPU "
        f"engine in route, QueryStats, cache stats and epochs, "
        f"{equal12a} of {n12a} answers bit for bit, the rest within rtol "
        f"1e-5; the metadata API equal; K1 launches {SERVE_SMALL_LAUNCHES} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    k1_13a, k2_13a, n13a, codec = phase_durable_small(torch, np, fg, fr, pkg)
    log(f"durable small: recovery, K2 over a recovered histogram shard, "
        f"K1-delta8 over a recovered gauge shard, narrow and wide ODP, "
        f"purge, durable age-out, inline, batch and cascade downsampling, "
        f"__col__ and routed, stitched resolution queries: {n13a} records "
        f"match the CPU run (routes, QueryStats, sink files); host codecs "
        f"{codec}; K1 launches by step {k1_13a}; K2 {sum(k2_13a.values())} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    engine, shard, reg_s = bench.build_engine("cuda")
    # 16b(ii) and (iii) first: they read bench.py's values as built, as
    # --rules does (phase 10b's mirror rounds them, 12b appends)
    r16b = phase_rules_on_bench(torch, np, fg, card, engine, shard)
    # phase 17 on the same store, still as built (16b only reads it)
    r17 = phase_locks(torch, np, fg, card, engine, shard)
    k1 = phase_scale(torch, np, fg, card, engine, shard, reg_s)
    log(f"scale: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _k1b, k3_launches, _res = phase_bench(np, fg, sp, bench, card, engine,
                                          shard, reg_s, k1["ms"])
    trace_concurrent_round(torch, bench, card, engine, shard)
    log(f"bench: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _lat8b, k1_8b = phase_general_scale(torch, np, fg, card, engine, shard)
    log(f"general scale: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _lat10, k1_10 = phase_subquery_scale(torch, np, fg, card, engine, shard)
    log(f"subquery scale: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k1_mirror = phase_mirror_scale(torch, np, fg, card, engine, shard)
    log(f"mirror scale: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k1_12b = phase_serving_scale(torch, np, fg, card, engine, shard)
    del engine, shard
    log(f"serving scale: done in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine, shard, reg_s = bench.build_engine("cuda", residency="gauge")
    log(f"narrow scale: registered {NUM_SERIES} series in {reg_s:.1f} s")
    k1n = {kind: phase_scale_narrow(torch, np, fg, card, shard, engine, kind)
           for kind in NARROW_KINDS}
    del engine, shard
    log(f"narrow scale: done in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    checks, exact, worst5 = phase_hist_kernels(torch, np, fr, narrow, "cuda")
    log(f"hist kernels: fusedhist_k2 ({checks} checks against the plain "
        f"twin, max |diff| {worst5:.3g}; {exact} bit-exact checks with one "
        f"row per group; {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    checks, exact, worst5s = phase_k2_shapes(torch, np, fr, narrow, "cuda")
    log(f"hist kernels: fusedhist_k2 launch shapes ({checks} checks against "
        f"the plain twin at unaligned row strides, C = 1024 with every cell "
        f"needed, G = 64 at Tp * B = 4096, S = 504, an all-excluded chunk, "
        f"no active step; max |diff| {worst5s:.3g}; {exact} bit-exact checks "
        f"with one row per group at unaligned strides; "
        f"{time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    small = phase_hist_small(torch, np, fr, hpkg)
    log(f"hist small: {len(HIST_SMALL_QUERIES)} queries x 2 residencies on "
        f"1024 histograms match the CPU engine; K2 launches {small} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_q, k1_9a, k2_9a = phase_hist_general_small(torch, np, fg, fr, hpkg)
    log(f"hist general small: {n_q} answers of the general histogram mix "
        f"over {len(HIST_GENERAL_SETS)} datasets of 1024 histograms match "
        f"the CPU engine; K1 launches {k1_9a}, K2 launches {k2_9a} (the "
        f"fused legs and K2-route answers) "
        f"({time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    k2, engine, shard, sampled = phase_hist_scale(torch, np, fr, card, hpkg)
    log(f"hist scale: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _lat9b, k1_9b = phase_hist_general_scale(torch, np, fg, fr, card, engine,
                                             shard, sampled)
    del engine, shard
    log(f"hist general scale: done in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    k1_11a = phase_mesh_small(torch, np, fg, pkg)
    log(f"mesh small: {len(MESH_SMALL_ROUTES)} queries over 8-shard "
        f"datasets with mesh=[\"cuda\"] match mesh=[\"cpu\"] * 8; K1 "
        f"launches by kind {k1_11a} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    k1_11b, _lat11b, _per_shard, mesh_shards = phase_mesh_scale(
        torch, np, fg, card, pkg, k1["ms"])
    log(f"mesh scale: done in {time.perf_counter() - t0:.1f} s")
    t14 = time.perf_counter()
    k1_14a = phase_cluster_small(torch, np, fg, pkg)
    t0 = time.perf_counter()
    k1_14b, _out14b = phase_cluster_scale(torch, np, fg, card, pkg,
                                          mesh_shards)
    log(f"cluster scale: done in {time.perf_counter() - t0:.1f} s")
    k1_18 = phase_soak(torch, np, fg, card, pkg, mesh_shards)
    del mesh_shards
    gc.collect()
    torch.cuda.empty_cache()
    k1_14c = phase_cluster_procs(torch, np, fg, card, pkg)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"cluster: phase 14 done in {time.perf_counter() - t14:.1f} s")
    k1_15 = phase_server(torch, np, fg, card, pkg)
    gc.collect()
    torch.cuda.empty_cache()
    r16 = phase_rules_server(torch, np, fg, card, pkg)
    k1_16 = r16b["k1"] + r16["k1"]
    log(f"rules: phase 16 done in {r16b['seconds'] + r16['seconds']:.1f} s "
        f"(16b(ii), (iii) {r16b['seconds']:.1f}; 16a, 16b(i) "
        f"{r16['seconds']:.1f}); K1 launches {k1_16}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k1_13b = phase_durable_scale(torch, np, fg, card, pkg)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"durable scale: done in {time.perf_counter() - t0:.1f} s")
    r19 = phase_bench_suite(torch, np, fg, fr, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"bench suite: done in {r19['seconds']:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    k1_rows = [{
        "name": "fusedgrid_k1" if kind == "raw" else f"fusedgrid_k1_{kind}",
        "variant": kind, "route": "cuda",
        "source": "filodb_tpu_torch/ops/csrc/fusedgrid.cu",
        "replaces": "filodb_tpu/ops/fusedgrid.py:224",
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None} for kind, r in [("raw", k1), *k1n.items()]]
    # K1 raw's main paths: phase 4's bench query, then the fused legs of
    # phases 8b (S1), 9b (H3) and 10 (Q1), the mesh routes of 11a/11b and
    # the serving path's misses and incremental tails (12a, 12b), each
    # counted from 0; the decode variants add the mesh's narrow routes and
    # the mirror's quant16 stream
    # phase 13a: K1 raw over the recovered shard and the families, K1-delta8
    # over the recovered gauge shard; 13b: the recovered 2^17 shard and the
    # loaded 5m family
    k1_13a_narrow = {kind: sum(v for w, v in k1_13a.items()
                               if w.endswith(f"[{kind}]"))
                     for kind in NARROW_KINDS}
    k1_13a_raw = sum(v for w, v in k1_13a.items() if "[" not in w) \
        - sum(k1_13a_narrow.values())
    # phase 14: the cluster plane's nodes (14a raw in-process, 14b the
    # adopted delta8 shards, 14c the node processes' raw shards); phase 15:
    # the FiloServer's shard leaves over HTTP (15a, 15b); phase 16: the
    # rule evaluations and the checks' queries (16a, 16b); phase 17: the
    # lock round's queries (its serial checks apart); phase 18: the three
    # nodes' legs over HTTP (18a, delta8), the validator's servers (18b),
    # the soaks (18c)
    # phase 19: the benchmark suites' main paths (their kernel-against-twin
    # checks apart), every kind
    k1_rows[0]["launches"] += k1_8b + k1_9b + k1_10 + k1_11a["raw"] \
        + k1_11b["raw"] + k1_12a + k1_12b + k1_13a_raw + k1_13b \
        + k1_14a + k1_14b["raw"] + k1_14c + k1_15 + k1_16 + r17["k1"] \
        + k1_18["raw"] + r19["k1"]["raw"]
    for row in k1_rows[1:]:
        kind = row["variant"]
        row["launches"] += k1_11a[kind] + k1_11b[kind] + (
            k1_mirror if kind == "quant16" else 0) + k1_13a_narrow[kind] \
            + k1_14b[kind] + (k1_18["delta8"] if kind == "delta8" else 0) \
            + r19["k1"][kind]
    log(f"K1 raw launches on the main paths: phase 4 {k1['launches']}, 8b "
        f"{k1_8b}, 9b {k1_9b}, 10 {k1_10}, 11a {k1_11a['raw']}, 11b "
        f"{k1_11b['raw']}, 12a {k1_12a}, 12b {k1_12b}, 13a {k1_13a_raw}, "
        f"13b {k1_13b}, 14a {k1_14a}, 14b {k1_14b['raw']}, 14c {k1_14c}, "
        f"15 {k1_15}, 16 {k1_16}, 17 {r17['k1']}, 18 {k1_18['raw']}, "
        f"19 {r19['k1']['raw']}; "
        f"K1-delta8 over a recovered shard (13a) "
        f"{k1_13a_narrow['delta8']}; decode variants on the mesh (11a, 11b) "
        f"and the two-node split (14b) "
        f"{ {k: (k1_11a[k], k1_11b[k], k1_14b[k]) for k in NARROW_KINDS} }, "
        f"the three nodes (18a) {k1_18['delta8']}, "
        f"quant16 through the mirror {k1_mirror}, the bench suites (19) "
        f"{ {k: r19['k1'][k] for k in NARROW_KINDS} }; K2 in 19 "
        f"{r19['k2']}")
    table = {"kernels": k1_rows + [{
        "name": "fusedhist_k2", "route": "cuda",
        "source": "filodb_tpu_torch/ops/csrc/fusedhist.cu",
        "replaces": "filodb_tpu/ops/fusedresident.py:282",
        "launches": k2["launches"] + sum(k2_13a.values()) + r19["k2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None}, {
        "name": "streamprobe_k3", "route": "cuda",
        "source": "filodb_tpu_torch/ops/csrc/streamprobe.cu",
        "replaces": "bench.py:184",
        "launches": k3_launches, "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"]}]}
    # every bound above is bytes over the data sheet's rate; K3's time is
    # the pass this card reaches over the same kind of bytes
    key, bw, _f32 = peaks_for(card)
    rate = k3["bound_ms"] * bw / k3["ms"]
    multiples = {r["name"]: (round(r["ms"] / (r["bound_ms"] * bw / rate), 2),
                             round(r["ms"] / r["bound_ms"], 2))
                 for r in table["kernels"] if r["bound_by"] == "bytes"}
    log(f"floors [{card}]: K3's pass {rate / 1e12:.3f} TB/s "
        f"({rate / bw:.3f} of {key}'s {bw / 1e12:.2f} TB/s); each kernel's "
        f"time as a multiple of its bytes at that pass and of its data-sheet "
        f"bound: {multiples}")
    print(card, flush=True)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
