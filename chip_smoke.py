#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, one line each:

1. build    — compile every CUDA kernel of ``raft_tpu_torch/csrc`` with
              nvcc (one process per source, all at once) into
              ``raft_tpu_torch/_build``.
2. kernels  — each kernel against its plain PyTorch version on CUDA
              tensors at each path's shapes: fused L2-NN at the card's
              default bf16x3 (tensor cores) at the k-means sweeps'
              (262144, 128) x (1024, 128) and the build's predict over
              all n rows (``fused_l2_nn@predict``), and select-k at
              (128, 1024) k=96 for IVF-Flat; the fused IVF-Flat scan over the real
              index for one 128-query batch, and the unfused list scan
              at k=512 on the same batch (after phase 3; both bf16x3 on
              the tensor cores, held to bf16x3 plain versions); on the real
              PQ index (after phase 4) both IVF-PQ scans for one
              128-query batch, the fused one at k=32 (kk=256), the
              unfused one at k=64 (kk=512), both on the list-major route
              of the default bf16 LUT tier and on the f32 body of the
              float32 tier (rows ``...@f32``), fused L2-NN at
              (262144, 128) x (4096, 128) and (n, 128) x (4096, 128)
              and select-k at (128, 4096) k=128 (rows tagged
              ``@ivf_pq``, ``@ivf_pq_predict``); on the real BQ index
              (after phase 5) both IVF-BQ scans likewise (kk=256 fused,
              kk=512 unfused) and select-k at (128, 1024) k=128
              (``select_k@ivf_bq``). Pass B alone, the payload radix
              select, on each fused user's candidate rows: IVF-Flat,
              IVF-PQ and IVF-BQ (one 128-query batch each; rows
              ``select_k_payload@ivf_flat|ivf_pq|ivf_bq``) and kernel
              5's L2 rows in phase 6 (``select_k_payload@bf``), against
              its plain version and ``torch.topk``; these rows carry the
              launches of the fused scan that runs them. Kernel, plain
              and library times from CUDA events after warm-up.
2b. kmeans_tiers — the trainer at kernel 1's other tiers, through
              ``balanced_kmeans`` on the 262144-row subsample: 10 sweeps
              at ``"bf16"`` (the tensor-core kernel, one pass; row
              ``fused_l2_nn@bf16``), then 10 sweeps at ``"highest"`` and
              the predict over all n rows through ``fused_l2_nn`` (the
              f32 body; rows ``fused_l2_nn@highest...`` at every shape of
              the bf16x3 rows, so each shape has a same-run comparison);
              each tier's seconds, launches by shape and mean squared
              distance to the assigned centre. Reproducible builds: two
              runs at one seed at bf16x3, bit for bit after each sweep
              and at the end (the smoke fails otherwise), and whether
              ``index_add_``, the fixed-order segment sum and
              ``torch.topk`` give the same bits twice on the card.
3. main     — the IVF-Flat serving path: a 10M x 128 clustered dataset
              (the benchmark's gaussian mixture, made on the card from a
              seed), IVF-Flat build (1024 lists, 10 k-means sweeps),
              ``SearchServer.from_index`` (batch shapes 1/8/32/128,
              96 probes, k=32), a burst of 512 single-query requests from
              128 threads; recall@32 against exact search, QPS, p50/p99,
              device memory, and each kernel's launch count over the run;
              then ``wide_flat``: one list-major ``ivf_flat.search`` of
              128 queries at k=512 (the unfused list scan and the
              candidate merge), its recall of the top 32 and its launch
              counts; then the index is dropped (``free``: device memory
              after the ``del`` and after a collection pass).
              ``serve_endpoint`` (after the main burst, on the same
              index): the debug endpoint (``obs.serve``, loopback) over a
              ``SearchServer`` of the main burst's settings. Fails
              unless ``/healthz`` answers 200 on the quiet server; the
              256 queries POSTed to ``/search`` as two 128-query JSON
              bodies give a direct ``srv.search``'s ids and float32
              distances; the first response's ``trace_id`` fetched from
              ``/debug/requests`` (``format=chrome``, and its fragments
              with ``all=1``, stitched) shows ``raft.serve.http``
              parenting the served request; a closed-loop burst of 512
              one-query POSTs from 8 threads (the endpoint's default
              bound) has no failed or dropped request, and the metrics
              history sampled through it (``enable_history(interval_s=
              0.25)``) gives ``raft.serve.requests``' rate within 25% of
              its QPS; an ``SLOTracker`` ticked around that burst with a
              latency objective that cannot hold (a 1 ms bucket edge at
              0.999) is named in ``/debug/slo`` and in ``/healthz``'s
              503; ``/metrics`` parses as Prometheus text with the
              registry's request total; ``/debug/profile`` answers 200;
              kernels 2 and 3 launched. Prints the burst's QPS and
              p50/p99 beside an 8-thread loop of direct searches and the
              main burst's, the median ms of a 128-query POST against a
              direct search of the same batch (ten of each, in turns),
              and the phase's seconds.
              ``serve_faults`` (after ``serve_endpoint``, on the same index):
              a server with the dispatch watchdog (2000 ms, 2 retries,
              1 ms backoff) serves the burst (the same checks, its
              QPS and p50/p99 beside the main burst's); 4 x 25 serial
              128-query requests through its ladder with and without
              the watchdog, and 4 x 100 through a plan that replays one
              result (the helper thread's cost per dispatch); one
              128-query request under an injected 4 s stall, retried
              once to ids equal to a direct ``plan.search``; three
              injected ``ShardFailedError`` that exhaust the retries,
              and the next request served.
              ``serve_quality`` (after ``serve_faults``, on the same
              index): the index's rows back from its lists
              (``corpus_from_index``); a rate-0 server attaches no
              monitor; a server at ``quality_sample_rate=1.0`` with an
              exact scorer over all n rows (153 chunks of 65536, kernel 2
              once a chunk and 32-query batch, on the monitor's own
              stream) serves the burst and is drained: 512 samples, no
              shadow error, no kernel library loaded while sampling, the
              monitor's recall within 0.002 of the burst's own recall@32,
              the scorer's ids on >= 99.9% of the exact truth's; QPS,
              p50/p99 beside the main burst's, the scorer's construction
              seconds, seconds and kernel 2 launches per 32-query shadow
              batch, kernel 2's launches during the drain; kernel 2 at the
              scorer's tile (32, 65536) k=32 against its plain version
              and ``torch.topk`` (row ``select_k@quality``); then 3 rounds
              of the burst with sampling off, on the shadow stream and on
              the default stream, in turn (their median QPS and p99).
              ``serve_obs`` (after ``serve_quality``, on the same index
              and server settings): the burst with tracing off and the
              resource profiler at rate 0 (no profiler state, no sampler
              thread, an empty flight recorder); the burst with tracing
              and the profiler at 1.0 (the request and queue-delay
              histograms count 512 each, ``raft.serve.batch.size``
              counts the batches and sums their rows, one profiler
              sample per blocking ``plan.search``, the recorder's ring
              full of traces with the batch tree ``raft.serve.execute``
              -> ``raft.plan.search`` -> ``raft.obs.profile.sync``, one
              Chrome trace valid JSON with each child inside its
              parent, the duty cycle in [0, 1.05], a forced memory
              sample equal to the allocator's bytes and the card's
              size, kernels 2 and 3 launched); then 3 rounds of the
              burst with everything off, tracing on and the profiler at
              0.01, and both at 1.0, in turn (median QPS and p99), the
              profiler's host and device ms a dispatch, and under
              ``--profile`` the duty cycle beside the ``torch.profiler``
              busy share of one more burst.
              ``serve_mutate`` (after ``serve_obs``, on the same index):
              the index wrapped as a ``MutableIndex`` (the default
              ``MutateConfig``: delta rungs 1024, 4096, 16384, slack 16,
              a fold at 8192 used slots) behind ``SearchServer`` and a
              ``Compactor``; bursts while a writer thread upserts 12,288
              rows of the dataset's mixture (another seed), deletes 4,096
              ids and re-upserts 1,024 others, until the writer and the
              compactor are quiet: no request may fail, every plan-cache
              miss of the run must be a fold's warm-up of the next epoch,
              the epoch must roll. Then, serially: no deleted id returned,
              >= 99% of the upserted rows their own nearest, the server's
              ids a direct search's, kernels 1 (the fold's predict), 2
              (column and payload) and 3 launched; the live recall@32
              against the exact top-32 of the live corpus, QPS and
              latency beside the main burst's, the fold's host seconds by
              part and device memory; kernel 2 at the tail's shapes
              (rows ``select_k@mutate`` at (128, 16384) k=32 and
              ``select_k_payload@mutate`` at (128, 80) k=32).
              ``serve_tiered`` (after ``serve_mutate``, on the same
              index): the lists to host memory (``to_host``: seconds,
              host bytes), a ``TieredIndex`` at ``hot_frac=0.3`` with
              staging chunks of at most 256 lists (fails unless it takes
              the 256-list hot rung; the rung, hot lists and budget
              printed); the 256 queries at 128 a batch through a tiered
              plan and ``host_memory.search``, each failing unless it
              gives the resident probe-order search's ids (the tiered
              distances within rtol 1e-5); a ``SearchServer`` burst (QPS,
              p50/p99, recall@32, the ``raft.tiered.*`` deltas: hit rate,
              fetch bytes and seconds, overlap fraction; the served ids a
              direct plan's), ``refresh()`` and a second burst; a
              refresh at half the budget (fails unless it demotes and
              the ids stay); then ``host_memory.build_streaming`` of all
              n rows in 1M-row host chunks (seconds; fails unless the
              peak device bytes above the pre-build baseline stay under
              half the corpus; recall@32 of its host search, floor 0.5).
              Rows ``select_k@tiered`` ((128, 1024) k=96, the coarse
              select), ``select_k_payload@tiered`` ((128, 64) k=32, the
              tier merge) and ``fused_l2_nn@stream`` ((1M, 128) x 1024, a
              chunk's labels); kernels 1 and 2 must have launched.
              ``mutate_durable`` (after ``serve_tiered``): the index as a
              ``MutableIndex`` with a WAL (fsync) and no checkpoint takes
              12,288 upserts, 4,096 deletes and 1,024 re-upserts in
              batches of 256 (the fsync's and each call's ms, p50/p99);
              the object is dropped and ``MutableIndex.recover`` replays
              the log onto the base index (seconds, records): fails
              unless the ids on the 256 queries are the live ones, every
              upserted row is its own rank-0 hit and no deleted id
              comes back. Then the checkpoint mode on a 1M-row cut
              (printed as a cut: a checkpoint writes the whole folded
              index, ~1.3 GB at 1M rows and ~13 GB at 10M): one fold
              (checkpoint seconds and bytes), fails unless the log was
              rewritten (a meta record first, sequence numbers still
              rising) and ``recover`` from the checkpoint and the log
              gives the live ids. The log and checkpoint live under
              ``chiprun_out/durable`` and are removed after the phase.
              ``serve_fleet`` (after ``mutate_durable``, in process, on
              the same index): three ``fleet.Replica``s, each a
              ``SearchServer`` (the main burst's settings) over its own
              ``MutableIndex`` on the shared base; the primary logs to a
              WAL, two followers come up through ``bootstrap_replica``
              and tail it with a ``Replicator``. The burst through a
              ``FleetRouter(FleetConfig(max_retries=1))`` while the
              primary takes serve_mutate's writes (the followers' lag in
              records sampled through it), then a burst with one
              follower ``kill()``ed in it (brought back through the
              restart below), then bursts while ``rolling_restart``
              drains and restarts every replica (followers bootstrapped
              again from the whole log: seconds). Fails unless no
              request fails in any round, each caught-up follower's ids
              on the 256 queries equal the primary's, the router's
              ``report()`` and ``/healthz``'s fleet section
              (``obs.serve(fleet=router)``) count three replicas serving,
              no request in a round with a kill or the restart in it is
              slower than ``stall_bound_ms``, and kernels 2 and 3
              launched on the routed bursts alone (launches read just
              before and after each burst). QPS, p50 and p99 a round,
              lag, bootstrap seconds. No fold of the 10M index.
              ``fleet_procs`` (after ``serve_fleet``): a
              ``ProcessFleet(n_procs=3, platform="cuda")`` of
              ``fleetd`` daemons at 2,000,000 x 128 (printed as a cut:
              three daemon copies share the card beside the 10M index),
              1024 lists, k=32, 96 probes, every daemon on card 0, the
              kernels only loaded (built in phase 1). Fails unless each
              daemon's log names this card, every daemon answers the 256
              queries with the same ids (one build at one seed, bit for
              bit), no request fails through a burst with writes to the
              primary over ``/rpc/upsert`` and ``/rpc/delete``, a burst
              with a follower SIGKILLed in it (then respawned), and a
              burst with the primary SIGKILLed and a follower promoted
              in it; the old primary, respawned as a follower,
              bootstraps from the new primary's checkpoint over
              ``/rpc/checkpoint`` (seconds, bytes) and every daemon ends
              with the new primary's ids; no request in a round with an
              action in it is slower than ``stall_bound_ms`` (a search
              RPC times out after ``PROC_RPC_TIMEOUT_S``); kernels 2 and
              3 launched on the 128-row ``/rpc/search`` requests and
              kernel 2 on the routed bursts (the daemons' launch counts
              from ``/rpc/state`` just before and after each; batches of
              at most ``PROC_POOL`` rows take the probe-major plan, so
              kernel 3 is not expected there); no daemon compiled a
              kernel and none is left running. QPS, p50/p99 a round, the
              card's memory in use with the daemons up, each daemon's
              kernel launches over its life (its exit log line).
              ``fleet_postmortem`` (after ``fleet_procs``): the port's
              load generator (``raft_tpu_torch.tools.loadgen.main``)
              twice in this process. (a) ``--fleet 3`` at 10,000,000 x
              128 (its own blobs and build: 1024 lists, k=32, probes
              96/48/24), 200 requests/s for 15 s, replica r1 killed
              at 5 s, the resource profiler at 0.5, a black box a
              replica under ``chiprun_out/fleet_postmortem/inproc``:
              fails unless the run ends 0 with no failed request, the
              report reads r1's dump, and the doctor, run on r1's dump
              after the run, finds r1's DOWN transition, final-window
              counter deltas, a verdict the JAX package's acceptance
              allows and the kill flush; kernel 2 launched in the open
              loop (``ops.launch_counts()`` around it alone: the
              probe-major plans' coarse select), and held to its plain
              version at that select's largest shape, (32, 1024) k=96
              (row ``select_k@probe_major``, its launches the open
              loop's). (b)
              ``--fleet-procs 3`` at fleet_procs' 2,000,000-row cut,
              100 requests/s for 20 s, ``--federate --blackbox``, r1
              SIGKILLed at 8 s, one rung of 96 probes (the daemons
              serve at ``--probes-ladder``'s last rung; with 96 a
              128-row request takes the list-major plan) and the one
              setting loadgen has no argument for, the daemons' batch
              shapes up to 128 (fleet_procs'; loadgen's are 1 and 8):
              fails unless the run ends 0 with no failed
              request, the federation section lists three instances on
              their own registries, the killed instance reads stale or
              unreachable and ``/fleet/healthz`` is 503 naming it while
              it is down, none is stale at the end (the respawned r1 is
              scraped at its new url, F17), after the load one
              ``scrape_once()`` gives a
              ``raft_serve_completed_total`` rollup on ``/fleet/metrics``
              equal to the sum of the live daemons' own ``/metrics``,
              ``/fleet/trace`` of one routed request stitches the
              router's fragment and a daemon's, the dead daemon's own
              dump (read before its respawn) has records, a verdict and
              its newest record within 2 s of the SIGKILL, and the
              survivors launched kernel 2 in the open loop (``/rpc/state``
              around it) and kernel 3 on 128-row ``/rpc/search``
              requests. Offered and achieved QPS, p50/p99 and the
              slowest request of each run, retries, route shares, the
              federator's scrape overhead, each box's flushes and bytes,
              the doctor's verdicts and evidence, the phase's seconds.
3a. serve_dist — the mesh-wide tier (after phase 3's index is freed):
              a mesh of every card, one rank each, or eight logical
              ranks on a lone card (``loadgen.dist_devices``); every
              ``comms.collective_checks`` function on it, and a one-rank
              NCCL group through ``comms.initialize_distributed`` whose
              allreduce, allgather, alltoall and bcast equal the
              in-process mesh's; two sharded trainer runs on the 262,144-row
              sample bit for bit; ``parallel.sharded_ivf_flat_build`` of
              the 10M rows over the mesh (1024 lists; seconds of the
              trainer, the label and widths pass and the bucket +
              alltoall + compaction; kernel 1's launches by shape; peak
              device memory, beside the reckoning printed before it):
              every id in exactly one list, ``list_sizes`` summing to n,
              a 100,000-row sample's lists equal to kernel 1's plain
              assignment (near-ties aside, >= 0.999); then
              ``DistributedSearchServer.from_sharded_index`` (the JAX
              bench's settings: shapes 1/8/32/128, 96 // 8 = 12 probes a
              shard, ladder 12/6/3, the int8 merge) under the 512-request
              burst: QPS, p50/p99, recall@32 beside ``main``'s; the
              served ids of the 256 queries equal a direct
              ``distributed_ivf_flat_search(merge="int8")``; the f32
              merge's recall within 0.005 of the int8 merge's;
              ``raft.parallel.plan.misses`` and ``raft.plan.build.total``
              flat through the burst; the merge-ratio gauge; then a
              server with ``failover=True``: ``stall_shard(3)`` plus its
              suspect gauge gives typed partial results (coverage 1 -
              rank 3's row share, 7 of 8 shards, the quality detail
              ``"3"``, no failed request) and clearing it recovers the
              full mesh with no plan built. Rows ``fused_l2_nn@sharded``
              (a rank's trainer shape), ``select_k@dist`` (a shard's
              coarse select, (128, 128) k=12) and
              ``select_k_payload@dist`` (the f32 merge's (128, 8 x 32)
              candidates, k=32), with ``torch.topk`` beside kernel 2.
              At its end the sharded index is gathered onto the card
              (``gather_index``) for 3d and the sharded one dropped.
3d. serve_dist_mutate — the gathered index as a ``MutableIndex`` (the
              default ``MutateConfig``) behind
              ``DistributedSearchServer.from_mutable`` (shapes 1/8/32/128,
              ladder 12/6/3, the int8 merge) over eight logical ranks:
              512-request bursts while ``mutate_writer`` upserts 12,288
              rows, deletes 4,096 and re-upserts 1,024 and one fold-mode
              ``compact()`` runs, until both are done. Fails unless no
              request fails, ``raft.parallel.plan.misses`` and
              ``raft.plan.cache.misses`` move only inside the compaction's
              warm-up (``_prewarm_epoch``), the epoch rolled; then no
              deleted id comes back (a 1,024-row sample), >= 0.99 of the
              upserted rows find themselves at rank 0 (2,048 of the new
              rows and every re-upsert), the server's ids equal a direct
              ``_MutableDistPlan.search``. Then ``compact(mode="rebuild",
              mesh=mesh)`` (``sharded_ivf_flat_build`` on the live rows):
              the epoch rolls, its lists are ``Sharded``, every live id
              sits in one list, a second burst prepares nothing; a fold
              of that sharded epoch (block by block) equals a fold of its
              lists gathered, lists and search ids. QPS, p50/p99,
              recall@32 against the live corpus's exact top 32, the
              fold's and the rebuild's seconds by part, peak memory
              beside the reckoning printed first.
3e. serve_parts — the row-sharded multi-part indexes over eight logical
              ranks: ``distributed_ivf_flat_build`` of the 10M rows
              (1024 lists; seconds of k-means++, Lloyd, label and width,
              bucketing; kernel 1's launches by shape; peak memory beside
              the reckoning printed first), every id once across the
              parts, ``distributed_ivf_flat_search_parts`` of the 256
              queries at 96 probes (recall@32, ms of 128-, 8- and 1-query
              searches), and the on-card check: one ``ivf_flat.Index``
              whose list l is the shards' parts of l side by side,
              searched probe-major at 96 probes, its ids on >= 0.999 of
              the entries and distances within 1e-5 relative. Then, at
              the 2M cut (a ``cut`` line says why), IVF-PQ parts (4096
              lists, 128 probes, pq 32 x 8, bf16 LUT) and IVF-BQ parts
              (1024 lists, 128 probes, rescore 8 on the card, the
              rescored distances exact for their ids): build seconds,
              recall@32 against the cut's exact top 32, ms a 128-query
              search. Rows ``fused_l2_nn@parts`` (1,250,000 x 1024 x
              128), ``@parts_pq`` (250,000 x 4096), ``@parts_bq``
              (250,000 x 1024) and ``select_k_payload@parts_bq`` (the BQ
              merge's (128, 8 x 256) candidates, k = 256).
3b. main_flat_bf16 — the same path at ``storage_dtype="bfloat16"``: build,
              burst, ``wide_flat`` (kernels 3 and 4 at ``Bf16Rows``, launch
              keys ``ivf_scan_bf16``, ``ivf_list_scan_bf16``), both scans
              against their plain versions (rows ``ivf_flat_scan@bf16``,
              ``ivf_list_scan@bf16``), ``free``.
3c. main_flat_int8 — at ``storage_dtype="int8"``: build on the first 90%
              of the rows, ``ivf_flat.extend`` with the rest (ids
              continuing the index's; the scale before and after), then
              as 3b (``Int8Rows``, keys ``..._int8``, rows ``...@int8``).
4. main_pq  — the IVF-PQ serving path on the same dataset, after the
              IVF-Flat index is freed: build (4096 lists, pq_dim 32 x 8
              bits, 10 sweeps, raw vectors kept), ``SearchServer`` with
              128 probes, k=32, rescore_factor 8 re-ranked on the card,
              the same burst, then one ``ivf_pq.search`` at k=64 (the
              unfused scan); the same measurements; then ``pq_f32``: one
              search at k=32 and one at k=64 at ``lut_dtype`` float32
              (the f32 body's two launch keys, counted alone), then both
              float32 scans on a small 768-d index at the default pq_dim
              (``pq_f32_wide``, kernel against plain); the index is then
              dropped (``free``), as after phase 5.
5. main_bq  — the IVF-BQ serving path on the same dataset, after the
              IVF-PQ index is freed: build (1024 lists, 10 sweeps, raw
              vectors kept; ``tools/north_star_recall.py``'s 10M BQ
              point), ``SearchServer`` with 128 probes, k=32,
              rescore_factor 8 re-ranked on the card (kk=256: the fused
              scan serves every batch), the same burst, then one
              ``ivf_bq.search`` at k=64 (kk=512, the unfused scan); the
              same measurements.
5b. main_pq_pc — phase 4's point with ``codebook_kind=PER_CLUSTER``,
              built on the first 90% of the rows and ``ivf_pq.extend``-ed
              with the rest (build and extend seconds), the same burst and
              k=64 search (main_pq's recall beside), both PQ scans against
              their plain versions (rows ``ivf_pq_scan_fused@per_cluster``,
              ``ivf_pq_scan@per_cluster``), then ``pq_scan_modes``: one
              128-query search at ``scan_mode="reconstruct"`` (list-major)
              and one at ``"lut"``, each with recall@32, seconds and the
              decode cache's device memory.
5c. main_bq_extend — phase 5's point built on 90% and ``ivf_bq.extend``-ed
              with the rest: the burst, recall@32, extend seconds and the
              launches of kernels 10 and 11.
5d. kmeans_two_level — ``build_hierarchical`` at 32768 lists on the
              10M rows (the two-level trainer), then the predict of every
              row: seconds, kernel 1's launches by shape, list sizes and
              the mean squared distance to the assigned centre.
6. main_bf  — brute-force k-NN on the same 10M x 128 dataset (the
              reference's ``knn.cuh`` case): 1000 queries from the same
              mixture, k=32, ``brute_force_knn(mode="fused")`` for
              L2Expanded, InnerProduct and CosineExpanded at the card's
              default precision (kernel 5's bf16x3 pass A on the tensor
              cores), then L2 at ``kernel_precision="highest"`` (its f32
              body); time and QPS over 3 reps after a warm-up, recall@32
              against ``mode="exact"`` and the exact scan's time, peak
              memory, launch counts, and kernel 5 against its plain
              version at the same arithmetic on the same inputs (rows
              ``fused_knn``, ``fused_knn@<metric>``,
              ``fused_knn@highest``).
7. wide_bf  — 10,000 x 8192 normal rows, 1000 queries, k=32, fused: the
              d > 4096 route (kernel 6) at the card's default bf16x3 on
              the tensor cores (row ``fused_knn_ktiled``) and at
              ``"highest"`` (its f32 body, ``fused_knn_ktiled@highest``),
              each against its plain version and recall against exact
              (gate 0.95).
8. pairwise — ``pairwise_distance`` at 8192 x 8192 x 256 on uniform
              [0, 1) data (hamming on values rounded to {0..3}) for
              every elementwise metric name (kernel 7, rows
              ``elementwise_dist@<name>``), each against its plain
              version, with one ``torch.cdist`` call as the library time
              where one computes the same function (hamming: the p=0
              count, divided by the dim for its error); the expanded
              metrics' times for context; one exact L1 ``brute_force_knn``
              of 100 queries over the first 1M rows (kernel 7 inside the
              exact scan). Two more rows: canberra where |a| + |b| lies in
              (2^126, 2^128) (``elementwise_dist@canberra_big``) and
              minkowski at p = 0 (``elementwise_dist@minkowski_p0``, +inf
              everywhere at dim 256), each against its plain version.
9. cluster  — the host-side users of the distances. ``kmeans.fit`` on the
              first 1M rows, k = 1024, 20 iterations, Random then
              k-means++ init (kernel 1 at bf16x3 for every assignment):
              seconds, iterations, inertia, kernel 1's launches by shape;
              a second fit at one seed bit for bit and the inertia within
              1e-3 of ``cluster_cost`` (fails otherwise); row
              ``fused_l2_nn@kmeans`` at (1M, 128) x (1024, 128).
              ``single_linkage`` over the kNN graph of the first 100,000
              rows (c = 15, 100 clusters): the seconds of the kNN graph,
              of each connectivity round (with the components before it),
              of the MST and of the dendrogram; the dendrogram checked
              (n - 1 merges of rising height, the last of size n, 100
              labels); then PAIRWISE on 4,096 rows against
              ``scipy.cluster.hierarchy.linkage(method="single")`` cut at
              100 clusters (labels equal up to renaming, heights within
              1e-4). ``silhouette_score`` of 50,000 rows at the fit's
              labels, euclidean and cityblock, each within 1e-4 of the
              port's CPU run on 5,000 of them (row
              ``elementwise_dist@silhouette_l1`` at (256, 50000, 128)). The
              sparse stack: the repo's wide case (512 x 256 rows of
              100,000 features, 64 nonzeros, col_tile 4096) against the
              dense distance of the densified rows; a narrow case (8192 x
              8192 rows of 1024 features at 5%) at cityblock and
              jensenshannon, bit for bit against the dense distance (rows
              ``elementwise_dist@sparse_narrow_l1|js``); a sparse k-NN of
              2000 queries over 50,000 rows of the wide form, k = 32, its
              first queries against ``torch.sparse.mm``. ``select_k`` at
              ``mode="approx"`` on one (128, 4096) batch at k = 128: the
              exact mode's ids, and kernel 2 launched.
10. primitives — the dense primitives and spectral partitioning.
              ``random.make_blobs`` of 1,048,576 x 32 points round 16
              centres on the card; their kNN graph at k = 15 in
              ``knn_graph``'s form (unit weights, CSR) from the fused
              brute force (kernel 5 and its pass B);
              ``spectral.partition`` into 16 clusters (normalized
              Laplacian, Lanczos, k-means on the 16-d embedding: kernel 1
              at (1,048,576, 16) x 16), ``analyze_partition``,
              ``analyze_modularity``, then ``modularity_maximization``:
              each part's seconds, the eigenvalues, the adjusted Rand index
              against the blob labels, edge cut, cost, modularity and
              kernel 1's launches by shape; fails unless the labels lie in
              [0, 16), everything is finite, the Laplacian's eigenvalues
              ascend within [-1e-3, 2 + 1e-3] and kernel 1 was launched;
              row ``fused_l2_nn@spectral`` (the embedding against the
              partition's centroids). Dense linear algebra: ``rsvd`` at
              rank 64 of a 262,144 x 1024 rank-64-plus-noise matrix (its
              singular values within 1e-2 of ``torch.linalg.svdvals``),
              ``eig_dc`` and ``svd_qr`` at 4096 x 4096 and ``lstsq_qr`` at
              262,144 x 256 (reconstruction and normal-equations residuals
              within 1e-4), ``stats.cov`` and ``stats.meanvar`` of the
              blobs against float64. ``linear_assignment`` at 2048 x 2048
              on integer costs in [0, 1000): a permutation, its objective
              beside scipy's and the auction rounds of each phase. R-MAT at
              Graph500's scale 20, edge factor 16, theta (0.57, 0.19, 0.19,
              0.05): the top-level quadrant shares within 0.01 of theta;
              ``make_regression`` at 1,048,576 x 128: the noise-free targets
              within 1e-4 of x @ coef + bias.

The exact search's truth for phases 3-5 (256 queries, k=32) comes from
the port's own ``brute_force_knn(mode="exact")``.

The build line reports the registers, shared memory and spills of the
radix select (both modes), the tensor-core fused L2-NN, the tensor-core
passes A of kernels 5/6, 3/4 (f32, bf16 and int8 rows), 8/9 and 10/11,
the IVF-PQ f32 body and every core of kernel 7 (``nvcc -Xptxas -v``).
Then a ``{"kernels": [...]}`` line, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before the last line. There is no CPU path: without CUDA the
script fails. ``--n`` cuts the dataset of every path (the cut is
printed).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

# peaks of the H100 SXM, NVIDIA's data sheet (dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_FLOPS = 67e12             # float32 outside the tensor cores
BF16_FLOPS = 989e12            # bf16 on the tensor cores
# instruction rates: the fp32 peak counts an FMA as two operations, so
# 128 lanes x 132 SMs x 1.98 GHz issue 33.5e12 fp32 instructions a
# second; special functions (log, exp, reciprocal) at 16 results a clock
# per SM (CUDA C++ Programming Guide, throughput table, compute 9.0)
FP32_INSTR = FP32_FLOPS / 2
SFU_OPS = 16 * 132 * 1.98e9
# kernel vs plain distance tolerance: rtol 1e-5 of the scale of the
# expanded-L2 terms (|x|^2 + |y|^2), where fp32 rounding of
# |x|^2 + |y|^2 - 2 x.y lives (a distance near 0 keeps that error)
RTOL = 1e-5
MIN_ID_AGREEMENT = 0.999
RECALL_FLOOR = 0.5

D, K, N_PROBES, N_LISTS, KMEANS_ITERS = 128, 32, 96, 1024, 10
# the IVF-Flat route for k > 256: list-major, the unfused list scan
FLAT_WIDE_K = 512
# IVF-Flat's narrow list storages: storage_dtype -> the tag of their phase,
# launch keys and rows; the int8 index is built on the first 1 - 1/10 of
# the rows and extended with the rest
FLAT_STORAGES = {"bfloat16": "bf16", "int8": "int8"}
EXTEND_SHARE = 10
# the IVF-PQ point: bench_suite.bench_ivf_pq(n=10M, nlists=4096,
# n_probes=128) with its defaults (k=32, pq_bits 8, pq_dim dim/4,
# rescore_factor 8), the re-rank kept on the card
PQ_LISTS, PQ_PROBES, PQ_BITS = 4096, 128, 8
# the float32 tier at a 768-d embedding's default pq_dim (192 x 8 bits:
# a 196,608 B table), a small synthetic index
F32W_ROWS, F32W_DIM, F32W_LISTS, F32W_PROBES = 16384, 768, 8, 4
# the IVF-BQ point: tools/north_star_recall.py's 10M BQ build (1024
# lists, 10 sweeps, raw kept) at its 128-probe operating point, k=32,
# rescore_factor 8 (the SearchParams default), the re-rank on the card
BQ_LISTS, BQ_PROBES = 1024, 128
# both quantized paths: kk = 8 * 32 = 256 takes the fused scan; one
# search at k=64 (kk = 512 > 256) takes the unfused scan and the merge
RESCORE, WIDE_K = 8, 64
KM_ROWS = 1 << 18             # the k-means trainer's subsample
# the two-level trainer's point: about sqrt(n) lists for a billion rows
TWO_LEVEL_LISTS = 32768
BATCH_SIZES = (1, 8, 32, 128)
N_QUERIES, N_REQUESTS, N_THREADS = 256, 512, 128
SERIAL_REQUESTS = 25          # a round of serve_faults' serial requests
# serve_quality: rounds of (sampling off, shadow on its own stream, shadow
# on the default stream) bursts, in turn
QUALITY_ROUNDS = 3
FAULTS_GUARD = dict(dispatch_timeout_ms=2000.0, max_retries=2,
                    retry_backoff_ms=1.0)
# serve_mutate: a writer upserts MUTATE_UPSERTS new rows of the dataset's
# mixture, deletes MUTATE_DELETES ids of the main index and re-upserts
# MUTATE_REUPSERTS others, in batches of MUTATE_BATCH, MUTATE_PACE_S
# apart, while bursts run (for at most MUTATE_TIMEOUT_S) until it and
# the compactor are done; 13,312 delta slots cross every rung of the
# default MutateConfig (1024, 4096, 16384) and its trigger (8192)
MUTATE_UPSERTS, MUTATE_DELETES, MUTATE_REUPSERTS = 12_288, 4_096, 1_024
MUTATE_BATCH, MUTATE_PACE_S, MUTATE_TIMEOUT_S = 512, 0.02, 120.0
MUTATE_SELF_HIT = 0.99
# serve_tiered: the tier's budget (a fraction of the list payload: the
# 256-list rung of 1024) and staging ceiling; the streaming build's host
# chunks; the recall floor of its host-memory search
TIER_HOT_FRAC, TIER_STAGE_LISTS, TIER_HOT_RUNG = 0.3, 256, 256
STREAM_CHUNK = 1_000_000
# mutate_durable: the writer of serve_mutate's sizes in batches of
# DURABLE_BATCH through a WAL with fsync; the checkpoint mode on the first
# DURABLE_CKPT_ROWS rows (a checkpoint writes the whole folded index:
# ~1.3 GB at 1M rows, ~13 GB at 10M) with DURABLE_CKPT_UPSERTS upserts
DURABLE_BATCH = 256
DURABLE_CKPT_ROWS, DURABLE_CKPT_UPSERTS = 1_000_000, 2_048
# serve_fleet: replicas in process (one primary with a WAL, followers
# tailing it); the router's retries; how long to wait for a follower to
# catch up
FLEET_REPLICAS, FLEET_MAX_RETRIES, FLEET_CATCHUP_S = 3, 1, 60.0
# fleet_procs: daemons on the card at a cut of the 10M dataset (three
# copies share the card beside the parent's index), their startup limit,
# the RPC pool a remote replica keeps (the endpoint's thread bound), the
# writes a burst sends the primary over HTTP
PROC_N, PROC_REPLICAS, PROC_STARTUP_S = 2_000_000, 3, 300.0
PROC_POOL, PROC_UPSERT_BATCHES, PROC_BATCH = 8, 8, 256
# a round with an action in it (a kill, a failover, a rolling restart,
# writes over HTTP) fails when its slowest request takes longer than
# FLEET_STALL_X times the larger of its own p99 and the last quiet
# round's, plus, through daemons, one search RPC's timeout and one load
# probe's (what a request to a SIGKILLed daemon may wait before its
# retry: the timeout is above the slowest request a promotion's fold
# caused, 8.8 s on an NVIDIA H100 80GB HBM3 at 700 W)
FLEET_STALL_X = 2.0
# serve_dist: per-shard probes (96 // 8, the JAX bench's 8-way mesh) and
# their ladder, the sample whose lists are held to kernel 1's plain
# assignment, the failover server's watchdog and the stalled shard's stall
DIST_PROBES, DIST_LADDER = 12, (12, 6, 3)
DIST_CHECK_ROWS, DIST_STALL_RANK, DIST_STALL_S = 100_000, 3, 4.0
DIST_FAILOVER = dict(failover=True, failover_probe_ms=200.0,
                     dispatch_timeout_ms=2000.0, max_retries=2,
                     retry_backoff_ms=1.0)
DIST_FAILOVER_REQUESTS = 32
# serve_dist_mutate: the upserted rows checked for their own rank-0 hit
# (every re-upsert besides) and the deleted rows searched, through the
# served plan (a 128-query mesh-wide search takes ~0.3 s on one card)
DIST_SELF_HIT_ROWS, DIST_DEAD_ROWS = 2048, 1024
PROC_RPC_TIMEOUT_S, PROC_PROBE_S = 12.0, 5.0
# fleet_postmortem: loadgen's in-process fleet at the full 10M rows and its
# daemon fleet at fleet_procs' cut, each with one replica killed; the
# verdicts the JAX package's acceptance allows a killed replica's dump
# (tests/test_blackbox.py); how far before the SIGKILL the dead daemon's
# newest record may lie (its boxes flush every 0.5 s)
PM_COMMON = ["--dim", str(D), "--n-lists", str(N_LISTS), "--k", str(K)]
PM_INPROC = ["--fleet", "3", "--n", "10000000", "--rate", "200",
             "--duration", "15", "--chaos", "kill_replica:1@t+5s+30s",
             "--profile-sample", "0.5", "--probes-ladder", "96,48,24"]
PM_PROCS = ["--fleet-procs", "3", "--n", str(PROC_N), "--rate", "100",
            "--duration", "20", "--federate", "--blackbox", "on",
            "--chaos", "kill_replica:1@t+8s+30s", "--probes-ladder", "96"]
PM_VERDICTS = ("host-bound", "device-bound", "shed storm", "healthy",
               "compile storm")
PM_NEWEST_S = 2.0
# serve_endpoint: the closed-loop HTTP burst's client threads (the
# endpoint's default bound), the 128-query POSTs timed against direct
# searches of the same batch (in turns), the history's sampling interval
# and the tolerance of its rate against the burst's QPS, and the latency
# objective that cannot hold (a 1 ms bucket edge at 0.999)
HTTP_THREADS, HTTP_BATCH_ROUNDS = 8, 10
HISTORY_INTERVAL_S, HISTORY_RATE_TOL = 0.25, 0.25
SLO_THRESHOLD_MS, SLO_TARGET = 1.0, 0.999
# brute force: the reference's cpp/bench/neighbors/knn.cuh:380-389 cases
# (10M x 128 and 10k x 8192, 1000 queries, k=32); the JAX package's
# recall gate for the fused kernel (BASELINE.md:43)
BF_QUERIES, BF_REPS, BF_RECALL_GATE = 1000, 3, 0.95
WIDE_N, WIDE_D = 10_000, 8192
# pairwise distances at bench_suite.py:37-51's 8192 x 8192 x 256; one
# exact L1 scan of L1_QUERIES queries over the first L1_ROWS rows
PAIR_N, PAIR_D = 8192, 256
L1_ROWS, L1_QUERIES = 1_000_000, 100
# elementwise kernel vs plain: float32 sums of 256 terms in two orders
# differ by up to ~2 x 256 x 2^-24 relative (logarithm cores alike)
ELT_RTOL, ELT_ATOL = 1e-4, 1e-5
# the elementwise metric names: name -> (core, sqrt, torch.cdist p giving
# the same function or None; p=0 counts the differing coordinates, which
# hamming divides by the dim)
PAIR_NAMES = {
    "cityblock": ("l1", False, 1.0),
    "sqeuclidean": ("l2unexp", False, None),
    "euclidean": ("l2unexp", True, 2.0),
    "chebyshev": ("linf", False, float("inf")),
    "canberra": ("canberra", False, None),
    "minkowski": ("minkowski", False, 3.0),
    "hamming": ("hamming", False, 0.0),
    "jensenshannon": ("jensen_shannon", False, None),
    "kl_divergence": ("kl", False, None),
    "braycurtis": ("braycurtis", False, None),
}
# the least work of each core per (i, j, dimension) element:
# (fp32 instructions, special-function results) — a difference and an
# add of its absolute value for l1; for canberra a reciprocal; for
# minkowski a log2 and an exp2; for jensen_shannon the log of the mean
# (the logs of a and b can be taken once a row, as for kl)
ELT_WORK = {"l1": (2, 0), "l2unexp": (2, 0), "linf": (2, 0),
            "canberra": (5, 1), "minkowski": (3, 2), "hamming": (2, 0),
            "jensen_shannon": (8, 1), "kl": (2, 0), "braycurtis": (4, 0)}
PAIR_EXPANDED = ("inner_product", "cosine", "correlation", "hellinger",
                 "russellrao", "jaccard", "dice")

# the pairwise_distance names of the rows that are not PAIR_NAMES keys
PAIR_ENTRY = {"canberra_big": "canberra", "minkowski_p0": "minkowski"}

# phase 9, cluster: Lloyd k-means on the first KM_FIT_ROWS rows (the
# survey's 1M-row k-means workload at the smoke's width), k = 1024, 20
# iterations, Random then k-means++ init; single-linkage on the first
# SL_ROWS rows (kNN graph, c = 15) and SL_PAIR_ROWS rows (pairwise),
# SL_CLUSTERS clusters; the silhouette of SIL_ROWS rows at the fit's
# labels, held to the CPU on SIL_SUB of them; the sparse cases: the
# repo's wide case (bench_suite.py bench_sparse_wide: 512 x 256 rows of
# 100,000 features, 64 nonzeros a row, col_tile 4096), a narrow one
# (8192 x 8192 rows of 1024 features at 5% density) and a k-NN (2000
# queries over 50,000 rows of the wide rows' form, k = 32); select_k at
# mode="approx" on one (128, 4096) batch at k = 128
KM_FIT_ROWS, KM_FIT_CLUSTERS, KM_FIT_ITERS = 1_000_000, 1024, 20
SL_ROWS, SL_C, SL_CLUSTERS, SL_PAIR_ROWS = 100_000, 15, 100, 4096
SIL_ROWS, SIL_SUB, SIL_TOL = 50_000, 5_000, 1e-4
SP_WIDE = (512, 256, 100_000, 64, 4096)     # m, n, features, nnz, col_tile
SP_NARROW = (8192, 8192, 1024, 0.05)        # m, n, features, density
SP_KNN = (2000, 50_000, 32, 64)             # queries, rows, k, checked
SP_TOL = 1e-4
APPROX = (128, 4096, 128)

# phase 10, primitives: spectral partition of SPEC_N blob points
# (SPEC_D features, SPEC_CLUSTERS centres) on their kNN graph at
# SPEC_KNN (unit weights); rsvd of a RSVD_SHAPE matrix of rank RSVD_K plus
# noise (a PCA sketch of embeddings), eig_dc and svd_qr at DENSE_N,
# lstsq_qr at LSTSQ_SHAPE, the auction at LAP_N on integer costs in
# [0, 1000); R-MAT at Graph500's scale and edge factor and theta;
# make_regression at REG_SHAPE. Residual gates: float32 factorisations
# give ~1e-6 (the CPU at these sizes), so 1e-4 catches a wrong result
SPEC_N, SPEC_D, SPEC_CLUSTERS, SPEC_KNN = 1 << 20, 32, 16, 15
RSVD_SHAPE, RSVD_K, RSVD_TOL = (262_144, 1024), 64, 1e-2
DENSE_N, LSTSQ_SHAPE, RESID_TOL = 4096, (262_144, 256), 1e-4
LAP_N = 2048
RMAT_SCALE, RMAT_EDGE_FACTOR = 20, 16
RMAT_THETA, RMAT_TOL = (0.57, 0.19, 0.19, 0.05), 0.01
REG_SHAPE, REG_TOL = (1 << 20, 128), 1e-4

# kernels whose compiled resources the build line reports
PTXAS_KERNELS = ("radix_select_kernel", "knn_bins_tc_kernel",
                 "list_scan_tc_kernel", "fused_l2_nn_tc_kernel",
                 "pq_f32_kernel", "elementwise_dist_kernel",
                 "knn_bins_kernel", "fused_l2_nn_kernel")

OUT_DIR = "chiprun_out"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def ptxas_summary(reports: dict) -> dict:
    """Registers, shared memory and spills of each PTXAS_KERNELS entry
    function, from ``nvcc -Xptxas -v`` output."""
    import re
    out, cur = {}, None
    for text in reports.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                hit = [kn for kn in PTXAS_KERNELS if kn in name]
                cur = (hit[0] + name.split(hit[0], 1)[1].split("Ev", 1)[0]
                       if hit else None)
                if cur:
                    out[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[cur]["spill_stores"] = int(m.group(1))
                out[cur]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                out[cur]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds of ``fn()`` with the host's launch cost
    taken out: ``reps`` calls captured into one CUDA graph, replayed
    ``replays`` times between two events. For kernels of a few
    microseconds, where a Python launch takes longer than the kernel and
    ``cuda_ms`` would time the host."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (reps * replays)


def bound(n_bytes: float, *work):
    """The least milliseconds for a function's work, and what bounds it:
    its bytes at the memory rate, or its operations, given as
    ``(count, rate)`` pairs at the card's peak rate for each operand
    type (units of different types can run at once, so the longest pair
    counts), whichever takes longer."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = max(n / rate * 1e3 for n, rate in work)
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def ann_dataset(n: int, d: int, nq: int, seed: int, dev):
    """The benchmark's clustered mixture: ``nc = max(64, min(8192,
    n // 125))`` standard-normal centres, rows = centre + unit noise;
    ``nq`` queries from the same mixture, then ``BF_QUERIES`` more for
    brute force. Drawn on the card from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nc = max(64, min(8192, n // 125))
    centers = torch.randn((nc, d), generator=g, device=dev)
    x = torch.empty((n, d), device=dev)
    step = 1 << 20
    for s in range(0, n, step):
        e = min(n, s + step)
        lab = torch.randint(0, nc, (e - s,), generator=g, device=dev)
        x[s:e] = centers[lab] + torch.randn((e - s, d), generator=g,
                                            device=dev)
    qs = []
    for m in (nq, BF_QUERIES):
        qlab = torch.randint(0, nc, (m,), generator=g, device=dev)
        qs.append(centers[qlab] + torch.randn((m, d), generator=g,
                                              device=dev))
    return x, qs[0], qs[1]


def compare(name, d_k, i_k, d_p, i_p, exact_ids: bool, scale=None):
    """Hold a kernel's (dists, ids) against the plain version's: exact
    equality, or the same empty (+inf) slots with the same ids there,
    and ids agreeing on >= 99.9% of the filled slots with every distance
    (so every disagreement is a near-tie) within ``RTOL * scale``."""
    d_k, d_p = d_k.double(), d_p.double()
    fin = torch.isfinite(d_p)
    if not torch.equal(torch.isfinite(d_k), fin):
        fail(f"{name}: finite pattern differs from the plain version")
    if not torch.equal(i_k[~fin], i_p[~fin]):
        fail(f"{name}: ids of the empty slots differ from the plain version")
    err = (d_k[fin] - d_p[fin]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    agree = float((i_k[fin] == i_p[fin]).double().mean()) if err.numel() \
        else 1.0
    if exact_ids:
        if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
            fail(f"{name}: output differs from the plain version "
                 f"(id agreement {agree})")
    else:
        tol = RTOL * scale.double()[fin]
        if bool((err > tol).any()):
            fail(f"{name}: distances off by up to {max_abs} "
                 f"(tolerance rtol {RTOL} of |x|^2 + |y|^2)")
        if agree < MIN_ID_AGREEMENT:
            fail(f"{name}: ids agree on {agree:.5f} < {MIN_ID_AGREEMENT}")
    return max_abs, agree


def product_ms(xa, ya) -> float:
    """Device ms of ``torch.mm`` of the f32 product ``xa @ ya.T`` with
    TF32 off (set and restored): the card's own yardstick for an f32
    body's products alone. It is not the kernel's function (no library
    row) and the port never calls it. A product past 2^30 entries is
    timed on a 2^20-row slice of its larger operand and scaled by the
    rows (the whole 10M-row product would need 40 GB)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        scale = 1.0
        if xa.shape[0] * ya.shape[0] > 1 << 30:
            if xa.shape[0] >= ya.shape[0]:
                scale, xa = xa.shape[0] / (1 << 20), xa[:1 << 20]
            else:
                scale, ya = ya.shape[0] / (1 << 20), ya[:1 << 20]
        return cuda_ms(lambda: torch.mm(xa, ya.T), 3) * scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def kernel_row(name, src, replaces, max_abs, ms, plain_ms, bnd, lib_ms):
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms}


def probe_stats(list_sizes, probes, inv_pos, cap: int) -> dict:
    """One batch's kept (query, probe) pairs (``inv_pos < cap``): the
    distinct probed lists, their rows counted once, the pairs, and the
    rows scored over all pairs."""
    kept = inv_pos < cap
    sizes = list_sizes.long()
    lists = torch.unique(probes[kept].long())
    return {"probed_lists": int(lists.numel()),
            "rows_once": int(sizes[lists].sum()), "pairs": int(kept.sum()),
            "pair_rows": int(sizes[probes[kept].long()].sum())}


def sample_rows(x, m: int, seed: int):
    g = torch.Generator(device=x.device).manual_seed(seed)
    return x[torch.randperm(x.shape[0], generator=g,
                            device=x.device)[:m]].contiguous()


# kernel 1's tiers: the plain version's arithmetic, the launch key, the
# source and the operations of its products: (passes, rate)
NN_TIERS = {
    "bf16x3": ("bf16x3", "fused_l2_nn",
               "raft_tpu_torch/csrc/fused_l2_nn_tc.cu", 3, BF16_FLOPS),
    "bf16": ("bf16", "fused_l2_nn",
             "raft_tpu_torch/csrc/fused_l2_nn_tc.cu", 1, BF16_FLOPS),
    "highest": ("f32", "fused_l2_nn_f32",
                "raft_tpu_torch/csrc/fused_l2_nn.cu", 1, FP32_FLOPS),
}


def check_fused_l2_nn(xa, ya, name, tier="bf16x3"):
    """fused L2-NN of ``xa`` against the centres ``ya`` at ``tier``
    (``kernel_precision``), against its plain version at the same
    arithmetic; ``name`` tags the path and shape. The bf16 tier's
    products are exact in f32 like bf16x3's, so the same rtol holds."""
    from raft_tpu_torch.ops import fused_l2_nn as op
    precision, _, src, passes, rate = NN_TIERS[tier]
    (m, dim), n = xa.shape, ya.shape[0]
    saved = (op.launches, op.launches_f32, dict(op.shapes))
    kernel = lambda: op.fused_l2_nn_cuda(xa, ya, False, precision)  # noqa: E731
    i_k, d_k = kernel()
    (i_p, d_p), plain_ms = cuda_once(
        lambda: op.fused_l2_nn_plain(xa, ya, False, precision))
    scale = (xa * xa).sum(1) + (ya * ya).sum(1)[i_p.long()]
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, False, scale)
    del i_k, d_k, i_p, d_p, scale
    ms = cuda_ms(kernel, 3 if m > KM_ROWS else 10)
    op.launches, op.launches_f32 = saved[:2]
    op.shapes.clear()
    op.shapes.update(saved[2])
    bnd = bound(4 * (m * dim + n * dim) + 8 * m,
                (passes * 2 * m * n * dim, rate))
    prod = product_ms(xa, ya) if precision == "f32" else None
    phase("kernels", kernel=name, shape=[m, n, dim], precision=precision,
          id_agreement=agree, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
          bound_ms=bnd[0], bound_by=bnd[1], product_ms=prod)
    row = kernel_row(name, src, "raft_tpu/ops/pallas_fused_l2_nn.py:34",
                     max_abs, ms, plain_ms, bnd, None)
    if prod is not None:
        row["product_ms"] = prod
    return row


def l2nn_shapes() -> dict:
    """Fused L2-NN launches since the last reset, by ``"m x n"``."""
    from raft_tpu_torch.ops import fused_l2_nn as op
    return {f"{m}x{n}": c for (m, n), c in sorted(op.shapes.items())}


def check_select_k(q, centers, k, name):
    """select-k of the coarse scores of one batch of at most 128 queries
    against ``centers`` at ``k`` probes, against its plain version."""
    from raft_tpu_torch.neighbors._ivf_scan import coarse_scores
    from raft_tpu_torch.ops import select_k as op
    v = coarse_scores(q[:128].contiguous(), centers).contiguous()
    m, n = v.shape
    saved = op.launches
    d_k, i_k = op.select_k_cuda(v, k)
    d_p, i_p = op.select_k_plain(v, k)
    torch.cuda.synchronize()
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, True)
    # device times by graph replay (the kernel takes ~10 us, less than a
    # Python launch); the eager per-call times, host included, beside them
    kernel = lambda: op.select_k_cuda(v, k)  # noqa: E731
    lib = lambda: torch.topk(v, k, dim=1, largest=False)  # noqa: E731
    ms, lib_ms = graph_ms(kernel), graph_ms(lib)
    eager_ms, lib_eager_ms = cuda_ms(kernel, 50), cuda_ms(lib, 50)
    plain_ms = cuda_ms(lambda: op.select_k_plain(v, k), 20)
    op.launches = saved
    bnd = bound(4 * m * n + 8 * m * k, (m * n, FP32_FLOPS))
    phase("kernels", kernel=name, shape=[m, n, k],
          id_agreement=agree, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
          library_ms=lib_ms, eager_ms=eager_ms, library_eager_ms=lib_eager_ms,
          bound_ms=bnd[0])
    return kernel_row(name, "raft_tpu_torch/csrc/select_k.cu",
                      "raft_tpu/ops/pallas_select_k.py:47", max_abs, ms,
                      plain_ms, bnd, lib_ms)


def check_pass_b(name, rows_d, rows_i, k: int, launches: int,
                 replaces: str):
    """Pass B alone, the payload radix select, on a fused scan's candidate
    rows ``rows_d``/``rows_i`` (m, n) at ``k``, against its plain version
    (exact: selection does no arithmetic) and ``torch.topk`` of the same
    rows; ``launches`` is the fused scan's (each of its launches runs pass
    B once). Rows of the IVF batches (~2M entries) are timed by graph
    replay, the brute-force rows eagerly."""
    from raft_tpu_torch.ops import select_k as op
    m, n = rows_d.shape
    saved = op.launches_payload
    d_k, i_k = op.select_k_payload_cuda(rows_d, rows_i, k)
    d_p, i_p = op.select_k_payload_plain(rows_d, rows_i, k)
    torch.cuda.synchronize()
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, True)
    del d_k, i_k, d_p, i_p
    kernel = lambda: op.select_k_payload_cuda(rows_d, rows_i, k)  # noqa: E731
    lib = lambda: torch.topk(rows_d, k, dim=1, largest=False)  # noqa: E731
    if m * n <= 1 << 22:
        ms, lib_ms = graph_ms(kernel), graph_ms(lib)
    else:
        ms, lib_ms = cuda_ms(kernel, 10), cuda_ms(lib, 10)
    plain_ms = cuda_ms(lambda: op.select_k_payload_plain(rows_d, rows_i, k),
                       3, warmup=1)
    op.launches_payload = saved
    # the values read once, the k ids of the kept columns, values and ids
    # written; a comparison per value
    bnd = bound(4 * m * n + 12 * m * k, (m * n, FP32_FLOPS))
    phase("kernels", kernel=name, shape=[m, n, k], id_agreement=agree,
          max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bnd[0], bound_by=bnd[1], launches=launches)
    row = kernel_row(name, "raft_tpu_torch/csrc/radix_select.cuh", replaces,
                     max_abs, ms, plain_ms, bnd, lib_ms)
    row["launches"] = launches
    return row


def run_kmeans_tiers(x, sample, cents, cents_pq):
    """Phase 2b: ``balanced_kmeans`` on ``sample`` at each tier of kernel
    1 (``bf16x3`` the default, ``bf16``, ``highest``), the highest run
    followed by the predict over every row of ``x``; each run's seconds,
    launches by shape and mean squared distance of the sample to its
    nearest centre (by the plain f32 version). Then kernel 1 at the bf16
    tier (the sweeps' shape) and the f32 body at every shape of the
    bf16x3 rows, against their plain versions; the rows carry the
    launches of their tier's run."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster.kmeans_balanced import balanced_kmeans
    from raft_tpu_torch.distance import fused_l2_nn
    from raft_tpu_torch.ops import fused_l2_nn as op
    launches = {}
    # one untimed sweep first: the first call of the trainer pays one-time
    # costs (allocator growth, the kernels' first launches)
    balanced_kmeans(sample, N_LISTS, 1, seed=3)
    torch.cuda.synchronize()
    for tier in ("bf16x3", "bf16", "highest"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        centers = balanced_kmeans(sample, N_LISTS, KMEANS_ITERS, seed=3,
                                  kernel_precision=tier)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        predict_s = None
        if tier == "highest":
            t0 = time.perf_counter()
            fused_l2_nn(x, centers, kernel_precision=tier)
            torch.cuda.synchronize()
            predict_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        launches[tier] = counts[NN_TIERS[tier][1]]
        if launches[tier] < KMEANS_ITERS:
            fail(f"kmeans at {tier}: {launches[tier]} launches of "
                 f"{NN_TIERS[tier][1]}")
        cost = float(op.fused_l2_nn_plain(sample, centers, False,
                                          "f32")[1].mean())
        phase("kmeans_tiers", tier=tier, n_clusters=N_LISTS,
              rows=sample.shape[0], sweeps=KMEANS_ITERS, train_s=train_s,
              predict_n=x.shape[0] if predict_s else None,
              predict_s=predict_s, mean_sq_dist=cost,
              fused_l2_nn_shapes=l2nn_shapes(),
              launches={k_: v for k_, v in counts.items() if v})
        del centers
    check_determinism(sample)
    rows = [check_fused_l2_nn(sample, cents, "fused_l2_nn@bf16", "bf16")]
    rows[0]["launches"] = launches["bf16"]
    for xa, ya, name in ((sample, cents, ""), (x, cents, "_predict"),
                         (sample, cents_pq, "_ivf_pq"),
                         (x, cents_pq, "_ivf_pq_predict")):
        row = check_fused_l2_nn(xa, ya, f"fused_l2_nn@highest{name}",
                                "highest")
        row["launches"] = launches["highest"]
        rows.append(row)
    return rows


def check_determinism(sample):
    """Reproducible builds: two runs of the trainer at one seed at the
    card's default bf16x3, compared bit for bit after each sweep (its own
    sweep, ``kmeans_balanced._em``, one at a time) and at the end of two
    ``balanced_kmeans`` calls; fails unless every comparison is equal.
    Beside it, on the labels of the last sweep, whether ``index_add_``
    (the sums the trainer took before) and the fixed-order
    ``segment_sum`` give the same bits twice, and whether ``torch.topk``
    of the costs (the reseed's earlier selection) gives the same rows
    twice."""
    from raft_tpu_torch.cluster import kmeans_balanced as kb
    from raft_tpu_torch.util.host_sample import sample_rows as host_rows
    from raft_tpu_torch.util.segment import segment_sum
    c0 = sample[host_rows(sample.shape[0], N_LISTS, 3, sample.device)]
    ca, cb, equal_after = c0, c0, []
    for _ in range(KMEANS_ITERS):
        ca = kb._em(sample, ca, N_LISTS, 1, 0.25)
        cb = kb._em(sample, cb, N_LISTS, 1, 0.25)
        equal_after.append(bool(torch.equal(ca, cb)))
    t1 = kb.balanced_kmeans(sample, N_LISTS, KMEANS_ITERS, seed=3)
    t2 = kb.balanced_kmeans(sample, N_LISTS, KMEANS_ITERS, seed=3)
    trained_equal = bool(torch.equal(t1, t2))
    labels, d = kb._nn(sample, ca)
    lab = labels.long()
    ia = [torch.zeros((N_LISTS, D), device=sample.device).index_add_(
        0, lab, sample) for _ in range(2)]
    ss = [segment_sum(sample, lab, N_LISTS)[0] for _ in range(2)]
    tk = [torch.topk(d, N_LISTS).indices for _ in range(2)]
    phase("kmeans_tiers", check="determinism", tier="bf16x3",
          rows=sample.shape[0], n_clusters=N_LISTS, sweeps=KMEANS_ITERS,
          sweeps_equal=equal_after, trained_equal=trained_equal,
          index_add_equal=bool(torch.equal(*ia)),
          index_add_max_abs_diff=float((ia[0] - ia[1]).abs().max()),
          index_add_rows_differing=int((ia[0] != ia[1]).any(1).sum()),
          segment_sum_equal=bool(torch.equal(*ss)),
          segment_sum_max_abs_diff_vs_index_add=float(
              (ss[0] - ia[0]).abs().max()),
          topk_equal=bool(torch.equal(*tk)))
    if not (all(equal_after) and trained_equal):
        fail(f"kmeans at one seed is not reproducible: sweeps "
             f"{equal_after}, trained {trained_equal}")


class Batch(NamedTuple):
    """One 128-query batch on a served index: the queries, the cap its
    plan measured, the coarse probes and their inversion."""
    qb: torch.Tensor
    cap: int
    probes: torch.Tensor
    qmap: torch.Tensor
    inv_pos: torch.Tensor


def probe_batch(index, q, n_probes: int, name: str) -> Batch:
    from raft_tpu_torch.neighbors import _ivf_scan
    qb = q[:128].contiguous()
    cap = index.cap_cache.get((128, n_probes))
    if cap is None:
        fail(f"{name}: the 128-row plan measured no cap")
    probes = _ivf_scan.coarse_probes(qb, index.centers, n_probes)
    qmap, inv_pos = _ivf_scan._invert_probes(probes, index.n_lists, cap)
    return Batch(qb, cap, probes, qmap, inv_pos)


def scan_bound(index, b: Batch, row_bytes: int, list_bytes: int, work):
    """``bound_fn`` of a batch's scan: each probed list's real rows
    (``row_bytes`` each, ids and norms included) and its ``list_bytes``
    read once, the queries once, the output written once; the
    operations ``work(info)``, ``(count, rate)`` pairs."""
    def bound_fn(out_bytes: int):
        info = probe_stats(index.list_sizes, b.probes, b.inv_pos, b.cap)
        n_bytes = (info["rows_once"] * row_bytes
                   + info["probed_lists"] * list_bytes + b.qb.numel() * 4
                   + out_bytes)
        return bound(n_bytes, *work(info)), info
    return bound_fn


def check_scan_kernel(name, op, counter: str, kernel, plain, scale,
                      reps: int, src: str, replaces: str, bound_fn,
                      **fields):
    """Hold one scan kernel's (dists, ids) against its plain version's
    on the same batch, within ``RTOL * scale(d_p, i_p)``; time both and
    return the kernel's row. ``op.<counter>`` is left as it was found,
    so the comparison adds no launch; ``bound_fn(out_bytes)`` gives the
    bound and the batch's sizes."""
    saved = getattr(op, counter)
    d_k, i_k = kernel()
    d_p, i_p = plain()
    torch.cuda.synchronize()
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, False,
                             scale(d_p, i_p))
    out_bytes = 8 * d_k.numel()
    del d_k, i_k, d_p, i_p
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, 1, warmup=1)
    setattr(op, counter, saved)
    bnd, info = bound_fn(out_bytes)
    phase("kernels", kernel=name, nq=128, **fields, **info,
          out_bytes=out_bytes, id_agreement=agree, max_abs_err=max_abs,
          ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1])
    return kernel_row(name, src, replaces, max_abs, ms, plain_ms, bnd, None)


def check_flat_scans(index, q, tag: str = ""):
    """Kernels 3 and 4 against their plain versions at the kernels'
    arithmetic on the served IVF-Flat index, one 128-query batch at the
    plan's cap: the fused scan at k=K and the unfused list scan at
    k=FLAT_WIDE_K. f32 rows: bf16x3, the kernels summing the three bf16
    products in one accumulator in the wgmma's order, the plain versions
    as three f32 products; bf16 and int8 rows (``tag`` "bf16", "int8"):
    one product of the rows and the bf16-rounded queries, exact either
    way. ``compare``'s tolerance covers the order. Rows ``...@<tag>``;
    for f32 rows, also kernel 3's candidate rows for pass B alone."""
    from raft_tpu_torch.ops import ivf_scan as op
    b = probe_batch(index, q, N_PROBES, "flat scan")
    data = (b.qb, index.lists_data, index.lists_norms, index.lists_indices)
    scale = index.scale
    suffix = f"_{tag}" if tag else ""
    at = f"@{tag}" if tag else ""
    src = "raft_tpu_torch/csrc/ivf_flat_scan.cu"
    # a dot product per kept (query, row) pair on the tensor cores: three
    # bf16 products for f32 rows (bf16x3, the TPU kernel's), one for
    # narrow rows; each row read once with its norm and id
    passes = 1 if tag else 3
    bound_fn = scan_bound(
        index, b, D * index.lists_data.element_size() + 8, 0,
        lambda info: [(passes * 2 * info["pair_rows"] * D, BF16_FLOPS)])
    qq = (b.qb * b.qb).sum(1)
    # fused: |q|^2 plus the norm of the row found
    ids_all = index.lists_indices.reshape(-1)
    norm_by_id = torch.zeros(index.size, device=b.qb.device)
    norm_by_id[ids_all[ids_all >= 0].long()] = \
        index.lists_norms.reshape(-1)[ids_all >= 0]
    fused = check_scan_kernel(
        "ivf_flat_scan" + at, op, "launches" + suffix,
        lambda: op.fused_list_scan_cuda(*data, b.probes, b.inv_pos, b.qmap,
                                        b.cap, K, 0, False, "l2", scale),
        lambda: op.fused_list_scan_plain(*data, b.probes, b.inv_pos, b.qmap,
                                         b.cap, K, 0, False, "l2", "bf16x3",
                                         scale),
        lambda d_p, i_p: qq[:, None] + norm_by_id[i_p.clamp(min=0).long()],
        5, src, "raft_tpu/ops/pallas_ivf_scan.py:360", bound_fn, k=K,
        cap=b.cap)
    del norm_by_id
    bins, _ = op.resolve_bins(0, FLAT_WIDE_K, index.lists_indices.shape[1])
    # per (list, slot): |q|^2 of the slot's query plus the list's
    # largest row norm
    slot = (qq[b.qmap.clamp(min=0).long()]
            + index.lists_norms.max(dim=1).values[:, None])
    wide = check_scan_kernel(
        "ivf_list_scan" + at, op, "launches_list" + suffix,
        lambda: op.list_scan_cuda(*data, b.qmap, bins, "l2", torch.float32,
                                  scale),
        lambda: op.list_scan_plain(*data, b.qmap, bins, "l2", torch.float32,
                                   "bf16x3", scale),
        lambda d_p, i_p: slot[:, :, None].expand_as(d_p),
        3, src, "raft_tpu/ops/pallas_ivf_scan.py:105", bound_fn,
        k=FLAT_WIDE_K, bins=bins, cap=b.cap)
    if tag:
        return fused, wide, None
    # kernel 3's candidate rows (pass A at the fused route's bins, through
    # kernel 4's blocks) for pass B alone
    saved = op.launches_list
    fbins, _ = op.resolve_bins(0, K, index.lists_indices.shape[1])
    rows = op.candidate_rows(*op.list_scan_cuda(*data, b.qmap, fbins, "l2"),
                             b.probes, b.inv_pos, b.cap)
    op.launches_list = saved
    return fused, wide, rows


def _pq_calls(index, params, b: Batch, q_rot, route):
    """The IVF-PQ scan that ``route`` takes on batch ``b``: kernel and
    plain callables, the code norms, the bins."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import ivf_pq_scan as op
    from raft_tpu_torch.ops.ivf_scan import resolve_bins
    books, round_q = ivf_pq._lut_books(index, params.lut_dtype)
    pc = route.per_cluster
    norms = ivf_pq._ensure_code_norms(index, params, pc, "l2")
    bins, _ = resolve_bins(route.bins, route.kk, index.codes.shape[1])
    a = (q_rot, index.centers_rot, books, index.codes, norms,
         index.lists_indices)
    if route.fused:
        return (lambda: op.pq_scan_fused_cuda(
                    *a, b.probes, b.inv_pos, b.qmap, b.cap, route.kk, bins,
                    False, "l2", round_q, pc),
                lambda: op.pq_scan_fused_plain(
                    *a, b.qmap, route.kk, bins, False, "l2", round_q, pc),
                norms, bins)
    return (lambda: op.pq_scan_cuda(*a, b.qmap, bins, "l2", round_q, pc,
                                    False),
            lambda: op.pq_scan_plain(*a, b.qmap, bins, "l2", round_q, pc,
                                     False),
            norms, bins)


def _pq_blocks(index, params, b: Batch, q_rot, bins: int):
    """Kernel 8's blocks at ``bins`` (the fused route's pass A, but for
    the IP centre term)."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import ivf_pq_scan as op
    books, round_q = ivf_pq._lut_books(index, params.lut_dtype)
    norms = ivf_pq._ensure_code_norms(index, params, False, "l2")
    return op.pq_scan_cuda(q_rot, index.centers_rot, books, index.codes,
                           norms, index.lists_indices, b.qmap, bins, "l2",
                           round_q, False, False)


def _bq_calls(index, params, b: Batch, q_rot, route):
    """The IVF-BQ scan that ``route`` takes on batch ``b``: kernel and
    plain callables, the rows' norms2, the bins."""
    from raft_tpu_torch.ops import ivf_bq_scan as op
    a = (q_rot, index.centers_rot, index.bits, index.norms2, index.scales,
         index.lists_indices)
    if route.fused:
        return (lambda: op.bq_scan_fused_cuda(
                    *a, b.probes, b.inv_pos, b.qmap, b.cap, route.kk,
                    route.bins, "l2"),
                lambda: op.bq_scan_fused_plain(*a, b.qmap, route.kk,
                                               route.bins, "l2"),
                index.norms2, route.bins)
    return (lambda: op.bq_scan_cuda(*a, b.qmap, route.bins, "l2"),
            lambda: op.bq_scan_plain(*a, b.qmap, route.bins, "l2"),
            index.norms2, route.bins)


def _bq_blocks(index, params, b: Batch, q_rot, bins: int):
    """Kernel 10's blocks at ``bins``."""
    from raft_tpu_torch.ops import ivf_bq_scan as op
    return op.bq_scan_cuda(q_rot, index.centers_rot, index.bits,
                           index.norms2, index.scales, index.lists_indices,
                           b.qmap, bins, "l2")


class Family(NamedTuple):
    """A quantized family's served point and how the smoke drives its
    two scans (``raft_tpu_torch.ops.<op>``, launch keys ``<op>`` and
    ``<op>_fused``, source ``csrc/<op>.cu``)."""
    tag: str             # phase main_<tag>, profile_burst_<tag>.txt
    label: str
    module: str          # raft_tpu_torch.neighbors.<module>
    op: str
    n_lists: int
    n_probes: int
    index_params: dict   # beyond n_lists, the sweeps and keep_raw
    fields: Callable     # index -> the family's fields of its phase
    calls: Callable      # _pq_calls / _bq_calls
    blocks: Callable     # _pq_blocks / _bq_blocks: the unfused blocks
    row_bytes: Callable  # index -> bytes of one list row (code, norms, id)
    work: Callable       # (index, params, info) -> (operations, rate) pairs
    replaces: tuple      # TPU kernels: (fused, unfused)
    f32_tier: bool       # IVF-PQ: the float32 LUT tier takes the f32 body
    grow: bool = False   # build on the first rows, extend with the rest
    row_tag: str = ""    # suffix of its scan rows' names
    # its rows: "all" (scans at each tier, pass B, kernel 1 and select-k
    # at its shapes), "scans" (the two scans), "none"
    rows: str = "all"
    scan_modes: bool = False  # IVF-PQ: one search at "reconstruct", "lut"


FAMILIES = (
    Family("pq", "IVF-PQ", "ivf_pq", "ivf_pq_scan", PQ_LISTS, PQ_PROBES,
           {"pq_bits": PQ_BITS, "pq_dim": 0},
           lambda index: {"pq_dim": index.pq_dim, "pq_bits": PQ_BITS},
           _pq_calls, _pq_blocks,
           lambda index: index.pq_dim + 8,
           # bf16 and fp8 tiers (list-major): the decoded rows against
           # the bf16 queries, a multiply and an add per (scored pair,
           # row, dimension) on the tensor cores; float32: the function's
           # least fp32 work, whatever body computes it (the CUDA-core
           # body decodes rows instead of building tables): an f32 table
           # of subspace products per kept (query, list) pair, then a
           # pq_dim-term sum per (pair, row)
           lambda index, params, info: [
               (info["pairs"] * index.pq_dim * index.pq_centers.shape[1]
                * index.pq_len * 2, FP32_FLOPS),
               (info["pair_rows"] * index.pq_dim, FP32_FLOPS)]
           if params.lut_dtype == torch.float32 else [
               (2 * info["pair_rows"] * index.rot_dim, BF16_FLOPS)],
           ("raft_tpu/ops/pallas_ivf_scan.py:499",
            "raft_tpu/ops/pallas_ivf_scan.py:851"), True),
    Family("bq", "IVF-BQ", "ivf_bq", "ivf_bq_scan", BQ_LISTS, BQ_PROBES, {},
           lambda index: {},
           _bq_calls, _bq_blocks,
           lambda index: index.words * 4 + 12,
           # the estimator's product of a +-1 tile and the bf16 query, a
           # multiply and an add per (scored pair, row, dimension): bf16
           # operands, so the tensor cores' bf16 rate
           lambda index, params, info: [
               (2 * info["pair_rows"] * D, BF16_FLOPS)],
           ("raft_tpu/ops/pallas_ivf_scan.py:428",
            "raft_tpu/ops/pallas_ivf_scan.py:737"), False),
)
# the same two points grown by extend: IVF-PQ with per-cluster books
# (phase main_pq_pc: rows "...@per_cluster" of kernels 8 and 9, and the
# "reconstruct" and "lut" scans) and IVF-BQ (phase main_bq_extend)
GROWN = (
    FAMILIES[0]._replace(
        tag="pq_pc", label="IVF-PQ per-cluster",
        index_params={"pq_bits": PQ_BITS, "pq_dim": 0,
                      "codebook_kind": 1},
        fields=lambda index: {"pq_dim": index.pq_dim, "pq_bits": PQ_BITS,
                              "codebook_kind": "PER_CLUSTER"},
        f32_tier=False, grow=True, row_tag="@per_cluster", rows="scans",
        scan_modes=True),
    FAMILIES[1]._replace(tag="bq_extend", label="IVF-BQ extended", grow=True,
                         rows="none"),
)


def scan_scale(fused: bool, b: Batch, q_rot, c_rot, norms):
    """``scale(d_p, i_p)`` of a quantized scan's outputs, where its f32
    rounding lives: fused, per query, the largest |qsub|^2 of its probes
    plus the largest row norm; unfused, per (list, slot), |qsub|^2 of the
    slot's query plus the list's largest row norm."""
    if fused:
        rr = ((q_rot[:, None, :] - c_rot[b.probes.long()]) ** 2).sum(-1)
        sc = rr.max(dim=1).values + norms.max()
        return lambda d_p, i_p: sc[:, None].expand_as(d_p)
    qs = q_rot[b.qmap.clamp(min=0).long()] - c_rot[:, None, :]
    sc = (qs * qs).sum(-1) + norms.max(dim=1).values[:, None]
    return lambda d_p, i_p: sc[:, :, None].expand_as(d_p)


def check_family_scans(fam: Family, index, q, params, launches: dict,
                       f32_launches: dict):
    """Both scans of ``fam`` against their plain versions on the served
    index, one 128-query batch: the fused one at k=K (kk = 256), the
    unfused one at k=WIDE_K (kk = 512); for IVF-PQ the same two at the
    float32 LUT tier (the f32 body, rows ``...@f32``, launches from the
    ``pq_f32`` searches); then pass B alone on the fused route's candidate
    rows. ``launches``: the path's main-path counts."""
    mod = importlib.import_module(f"raft_tpu_torch.neighbors.{fam.module}")
    op = importlib.import_module(f"raft_tpu_torch.ops.{fam.op}")
    b = probe_batch(index, q, fam.n_probes, fam.op)
    q_rot = (b.qb @ index.rotation_matrix.T).contiguous()
    c_rot = index.centers_rot
    # (params, row tag, counter and launch-key suffix, launch counts)
    tiers = [(params, fam.row_tag, "", launches)]
    if fam.f32_tier:
        tiers.append((dataclasses.replace(params, lut_dtype=torch.float32),
                      "@f32", "_f32", f32_launches))
    rows = []
    for prm, tag, suffix, counts in tiers:
        bound_fn = scan_bound(index, b, fam.row_bytes(index), D * 4,
                              lambda info, prm=prm: fam.work(index, prm,
                                                             info))
        for k, key, replaces in (
                (K, fam.op + "_fused", fam.replaces[0]),
                (WIDE_K, fam.op, fam.replaces[1])):
            route = mod._Route(index, k, prm)
            kernel, plain, norms, bins = fam.calls(index, prm, b, q_rot,
                                                   route)
            scale = scan_scale(route.fused, b, q_rot, c_rot, norms)
            counter = ("launches_fused" if route.fused else "launches") \
                + suffix
            row = check_scan_kernel(
                key + tag, op, counter, kernel, plain, scale,
                10 if route.fused else 5, f"raft_tpu_torch/csrc/{fam.op}.cu",
                replaces, bound_fn, kk=route.kk, bins=bins, cap=b.cap,
                **({"lut": str(prm.lut_dtype).replace("torch.", "")}
                   if fam.f32_tier else {}))
            row["launches"] = counts[key + suffix]
            rows.append(row)
    if fam.rows == "scans":
        return rows
    # pass B alone on the fused route's candidate rows (the unfused
    # blocks at the fused bins; L2, so no centre term)
    from raft_tpu_torch.ops.ivf_scan import candidate_rows
    route = mod._Route(index, K, params)
    bins = fam.calls(index, params, b, q_rot, route)[3]
    saved = op.launches
    cand = candidate_rows(*fam.blocks(index, params, b, q_rot, bins),
                          b.probes, b.inv_pos, b.cap)
    op.launches = saved
    rows.append(check_pass_b(f"select_k_payload@{fam.module}", *cand,
                             route.kk, launches[fam.op + "_fused"],
                             "raft_tpu/ops/pallas_ivf_scan.py:241"))
    return rows


def run_pq_f32(mod, index, q, params):
    """The float32 LUT tier through the entry point (the f32 body): one
    128-query search at k=K (the fused scan) and one at k=WIDE_K (the
    unfused scan and the merge), the counts reset just before and read
    just after."""
    from raft_tpu_torch import ops
    prm = dataclasses.replace(params, lut_dtype=torch.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for k in (K, WIDE_K):
        d, i = mod.search(index, q[:128], k, prm)
        if tuple(i.shape) != (128, k) or bool((i < 0).any()) or \
                not bool(torch.isfinite(d).all()):
            fail(f"IVF-PQ float32 tier k={k}: missing neighbours")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launched("IVF-PQ float32", launches, ("ivf_pq_scan_f32",
                                                "ivf_pq_scan_fused_f32"))
    phase("pq_f32", nq=128, k=[K, WIDE_K], seconds=time.perf_counter() - t0,
          launches={k_: v for k_, v in launches.items() if v})
    check_pq_f32_wide(mod, params)
    return launches


def check_pq_f32_wide(mod, params):
    """The float32 tier past the 160 KB table its first body held whole in
    shared memory: a synthetic F32W_ROWS x F32W_DIM index of F32W_LISTS
    lists at the default pq_dim (dim / 4) x PQ_BITS bits, both scans for
    one 128-query batch at F32W_PROBES probes, kernel against plain. Its
    launches are not the main path's."""
    from raft_tpu_torch.neighbors import _ivf_scan
    from raft_tpu_torch.ops import ivf_pq_scan as op
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((F32W_ROWS, F32W_DIM), generator=g, device="cuda")
    q = torch.randn((128, F32W_DIM), generator=g, device="cuda")
    index = mod.build(x, mod.IndexParams(n_lists=F32W_LISTS, pq_bits=PQ_BITS,
                                         kmeans_n_iters=4))
    table = index.pq_dim * (1 << PQ_BITS) * 4
    if table <= 160 * 1024:
        fail(f"IVF-PQ float32 at dim {F32W_DIM}: a {table} B table")
    prm = dataclasses.replace(params, n_probes=F32W_PROBES,
                              lut_dtype=torch.float32)
    saved = (op.launches_f32, op.launches_fused_f32)
    _ivf_scan.resolve_cap(index.cap_cache, q, index.centers, prm,
                          F32W_PROBES, index.n_lists)
    b = probe_batch(index, q, F32W_PROBES, "IVF-PQ float32 wide")
    q_rot = (b.qb @ index.rotation_matrix.T).contiguous()
    errs = {}
    for k in (K, WIDE_K):
        route = mod._Route(index, k, prm)
        kernel, plain, norms, _ = _pq_calls(index, prm, b, q_rot, route)
        d_k, i_k = kernel()
        d_p, i_p = plain()
        torch.cuda.synchronize()
        scale = scan_scale(route.fused, b, q_rot, index.centers_rot, norms)
        errs[k] = compare(f"IVF-PQ float32 at rot_dim {index.rot_dim} k={k}",
                          d_k, i_k, d_p, i_p, False, scale(d_p, i_p))[0]
    op.launches_f32, op.launches_fused_f32 = saved
    phase("pq_f32_wide", rows=F32W_ROWS, dim=F32W_DIM, n_lists=F32W_LISTS,
          pq_dim=index.pq_dim, pq_bits=PQ_BITS, table_bytes=table,
          n_probes=F32W_PROBES, max_abs_err={str(k): v for k, v in
                                             errs.items()},
          seconds=time.perf_counter() - t0)


def closed_loop(call, threads: int):
    """N_REQUESTS calls ``call(r)`` from ``threads`` threads, each sending
    its share one after another → (latencies, wall seconds, errors)."""
    lat = [0.0] * N_REQUESTS
    errors = []
    barrier = threading.Barrier(threads + 1)

    def worker(t):
        barrier.wait()
        for r in range(t, N_REQUESTS, threads):
            t0 = time.perf_counter()
            try:
                call(r)
            except Exception as e:  # reported after the join
                errors.append(repr(e))
                return
            lat[r] = time.perf_counter() - t0

    pool = [threading.Thread(target=worker, args=(t,), daemon=True)
            for t in range(threads)]
    for th in pool:
        th.start()
    barrier.wait()
    t0 = time.perf_counter()
    for th in pool:
        th.join()
    return np.asarray(lat), time.perf_counter() - t0, errors


def serve_burst(srv, q_np):
    """512 single-query requests from 128 threads, each thread sending
    its share one after another; returns per-request (dists, ids),
    latencies and the burst's wall time."""
    dists = [None] * N_REQUESTS
    ids = [None] * N_REQUESTS

    def call(r):
        d, i = srv.search(q_np[r % len(q_np)], timeout=600)
        dists[r], ids[r] = d[0], i[0]

    lat, wall, errors = closed_loop(call, N_THREADS)
    if errors:
        fail(f"serve: {len(errors)} requests failed, first {errors[0]}")
    return np.stack(dists), np.stack(ids), lat, wall


def profile_burst(srv, q_np, tag: str) -> None:
    """Trace one more burst (``profile_run``)."""
    profile_run(lambda: serve_burst(srv, q_np)[-1], tag,
                f"profile_burst_{tag}")


def profile_run(run, tag: str, out_name: str) -> float:
    """Trace ``run()`` (which returns its wall seconds) with
    ``torch.profiler``: device time by kernel into
    ``chiprun_out/<out_name>.txt``, and the device's busy share of the
    wall time, returned (kernels on one stream do not overlap, so their
    summed self time is the busy time). Only the device's own records (kernels,
    copies, fills) count: an operator's row repeats its kernels' time,
    as the table's "Self CUDA time total" leaves it out, and the port's
    own ``raft.*`` ranges (its spans and ``obs.timed`` scopes), which the
    trace also lists as device rows, cover its kernels' time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    ka = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in ka
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("raft.")), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    with open(os.path.join(OUT_DIR, f"{out_name}.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    share = busy_us / 1e3 / (wall * 1e3)
    phase("profile", path=tag, wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
          busy_share=share,
          top=[{"name": n[:60], "device_ms": t / 1e3, "calls": c}
               for n, t, c in rows[:8]])
    return share


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def counter_deltas(before: dict, after: dict, prefix: str) -> dict:
    """How far each counter series under ``prefix`` moved."""
    return {k_: after["counters"][k_] - before["counters"].get(k_, 0)
            for k_ in after["counters"] if k_.startswith(prefix)}


def latency_row(lat, wall) -> dict:
    """A burst of N_REQUESTS: its wall seconds, QPS, p50 and p99 (ms)."""
    p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
    return dict(burst_s=wall, qps=N_REQUESTS / wall, p50_ms=p50,
                p99_ms=p99)


def serve_phase(srv, q_np, truth, n_rows: int, profile: str = "",
                close: bool = True):
    """The burst through a started server: checked results, recall@K,
    QPS and latency; the server is closed afterwards unless ``close`` is
    false."""
    from raft_tpu_torch import obs
    before = obs.snapshot()
    try:
        served_d, served, lat, wall = serve_burst(srv, q_np)
        after = obs.snapshot()
        if profile:
            profile_burst(srv, q_np, profile)
    finally:
        if close:
            srv.close()
    batches = counter_deltas(before, after, "raft.serve.batch")
    if served.shape != (N_REQUESTS, K):
        fail(f"served ids have shape {served.shape}")
    if (served < 0).any() or (served >= n_rows).any():
        fail("served ids out of range")
    if not np.isfinite(served_d).all() or (np.diff(served_d, axis=1) < 0).any():
        fail("served distances are not finite and ascending")
    hits = [len(set(served[r]) & set(truth[r % N_QUERIES]))
            for r in range(N_REQUESTS)]
    recall = float(np.mean(hits)) / K
    if recall < RECALL_FLOOR:
        fail(f"recall@{K} = {recall} < {RECALL_FLOOR}")
    return dict(requests=N_REQUESTS, threads=N_THREADS,
                **latency_row(lat, wall), **{f"recall_at_{K}": recall},
                batches=batches)


def check_launched(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] <= 0:
            fail(f"the {path} path never launched the {name} kernel")


def serve_flat(index, q_np, truth, n_rows: int, profile: str):
    """``SearchServer`` over an IVF-Flat index (96 probes, k=K) and the
    burst: ``(ladder seconds, serve_phase's fields, the burst's
    launches)``."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    t0 = time.perf_counter()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=ivf_flat.SearchParams(n_probes=N_PROBES),
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0))
    ladder_s = time.perf_counter() - t0
    pre_burst = ops.launch_counts()
    served = serve_phase(srv, q_np, truth, n_rows, profile)
    after = ops.launch_counts()
    return ladder_s, served, {k_: after[k_] - pre_burst[k_] for k_ in after}


class Replay(NamedTuple):
    """A plan that returns one result it was given: a dispatch without
    its work, so a server over it times only its own path."""

    nq: int
    n_probes: int
    device: torch.device
    out: tuple

    def search(self, queries, block: bool = False):
        return self.out


def serial_ms(ladder, q_np, requests: int, rounds: int = 4) -> dict:
    """Median latency (ms) of ``requests`` 128-query requests sent one
    after another to a server over ``ladder`` with the serve_faults
    watchdog and to one without it (no batching window), the two taking
    turns in alternating order for ``rounds`` rounds."""
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    servers = {tag: SearchServer(ladder, ServeConfig(
        batch_sizes=ladder.shapes, max_wait_ms=0.0, **kw))
        for tag, kw in (("watchdog", FAULTS_GUARD), ("inline", {}))}
    lat = {tag: [] for tag in servers}
    try:
        for rnd in range(rounds):
            for tag in list(servers)[::1 if rnd % 2 == 0 else -1]:
                for r in range(requests):
                    t0 = time.perf_counter()
                    servers[tag].search(np.roll(q_np, r, axis=0)[:128],
                                        timeout=600)
                    lat[tag].append(time.perf_counter() - t0)
    finally:
        for srv in servers.values():
            srv.close()
    return {tag: float(np.median(v)) * 1e3 for tag, v in lat.items()}


def run_serve_faults(index, q_np, truth, n_rows: int, main: dict) -> None:
    """Phase 3 ``serve_faults``: the served burst through the dispatch
    watchdog (each dispatch on its helper thread), the helper's cost per
    dispatch, an injected 4 s stall retried to a direct
    ``plan.search``'s ids, and injected shard failures that exhaust the
    retries, with the request after them served."""
    from raft_tpu_torch import obs, ops
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import (PlanLadder, SearchServer, ServeConfig,
                                      ShardFailedError)
    from raft_tpu_torch.testing import faults
    ops.reset_launch_counts()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=ivf_flat.SearchParams(n_probes=N_PROBES),
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0, **FAULTS_GUARD))
    try:
        served = serve_phase(srv, q_np, truth, n_rows, close=False)
        burst = ops.launch_counts()
        check_launched("watchdog burst", burst, ("select_k", "ivf_scan"))
        # the helper's cost per dispatch: the 128-row plan with and
        # without the watchdog, and a replay of its result (the
        # dispatch path alone)
        q128 = q_np[:128]
        plan = srv.ladder.plan_for(128, 0)[1]
        serial = serial_ms(srv.ladder, q_np, SERIAL_REQUESTS)
        replay = serial_ms(PlanLadder((128,), (N_PROBES,), {(128, 0): Replay(
            128, N_PROBES, plan.device, plan.search(q128, block=True))},
            plan.dim, plan.k), q_np, 4 * SERIAL_REQUESTS)
        before = obs.snapshot()
        t0 = time.perf_counter()
        with faults.delay_execute(4000.0, max_hits=1) as rule:
            _, i_served = srv.search(q128, timeout=600)
        retried_s = time.perf_counter() - t0
        stall = counter_deltas(before, obs.snapshot(), "raft.serve.")
        want = {"raft.serve.dispatch.timeouts.total": 1,
                "raft.serve.retry.total": 1,
                "raft.serve.retry.success.total": 1}
        if rule.hits != 1 or any(stall.get(k_, 0) != v
                                 for k_, v in want.items()):
            fail(f"serve_faults: the stalled request moved {stall}, "
                 f"{rule.hits} stall(s), not one timeout and one retry")
        i_direct = plan.search(q128, block=True)[1].cpu().numpy()
        if not np.array_equal(i_served, i_direct):
            fail(f"serve_faults: the retried request's ids differ from a "
                 f"direct plan.search in {(i_served != i_direct).sum()} "
                 f"places")

        before = obs.snapshot()
        with faults.inject_fault(
                "serve.execute", error=lambda: ShardFailedError("chaos"),
                max_hits=3) as rule:
            try:
                srv.search(q_np[:1], timeout=600)
                fail("serve_faults: three shard failures were served")
            except ShardFailedError:
                pass
        d_after, i_after = srv.search(q_np[1:2], timeout=600)
        chaos = counter_deltas(before, obs.snapshot(), "raft.serve.")
        if rule.hits != 3 or \
                chaos.get("raft.serve.retry.exhausted.total", 0) != 1:
            fail(f"serve_faults: {rule.hits} injected failures moved "
                 f"{chaos}, not one exhausted retry budget")
        if i_after.shape != (1, K) or (i_after < 0).any() or \
                (i_after >= n_rows).any() or not np.isfinite(d_after).all():
            fail("serve_faults: the request after the failures was not "
                 "served")
    finally:
        srv.close()
        # the abandoned helper ends once its stalled call returns
        for th in threading.enumerate():
            if th.name == "raft-serve-watchdog":
                th.join(timeout=60)
                if th.is_alive():
                    fail("serve_faults: a dispatch helper still runs 60 s "
                         "after the server closed")
    phase("serve_faults", **FAULTS_GUARD, **served,
          main_burst={k_: main[k_] for k_ in ("qps", "p50_ms", "p99_ms")},
          serial_requests=4 * SERIAL_REQUESTS, serial_median_ms=serial,
          replay_requests=16 * SERIAL_REQUESTS, replay_median_ms=replay,
          helper_ms_per_dispatch=replay["watchdog"] - replay["inline"],
          helper_ms_per_plan_dispatch=serial["watchdog"] - serial["inline"],
          burst_launches=burst, stalled_request_s=retried_s,
          stalled_ids_equal_direct=True, stall_counters=stall,
          chaos_counters=chaos)


def check_select_k_tile(scorer, q_np, name):
    """Kernel 2 at the quality scorer's tile: the scores of its first 32
    queries against its first chunk (``(batch, chunk)`` at k = the
    scorer's tile k)."""
    from raft_tpu_torch.core.precision import full_fp32_matmul
    qb = torch.from_numpy(q_np[:scorer.batch]).to(scorer.device)
    full_fp32_matmul()
    v = (scorer._norms[0][None, :]
         - 2.0 * (qb @ scorer._chunks[0].T)).contiguous()
    return check_select_k_rows(name, v, scorer._k_tile)


def check_select_k_rows(name, v, k: int):
    """Kernel 2 (column ids) on the rows ``v`` (m, n) at ``k``, against
    its plain version (exact) and ``torch.topk``, timed by graph
    replay."""
    from raft_tpu_torch.ops import select_k as op
    m, n = v.shape
    saved = op.launches
    d_k, i_k = op.select_k_cuda(v, k)
    d_p, i_p = op.select_k_plain(v, k)
    torch.cuda.synchronize()
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, True)
    kernel = lambda: op.select_k_cuda(v, k)  # noqa: E731
    lib = lambda: torch.topk(v, k, dim=1, largest=False)  # noqa: E731
    ms, lib_ms = graph_ms(kernel), graph_ms(lib)
    plain_ms = cuda_ms(lambda: op.select_k_plain(v, k), 5, warmup=1)
    op.launches = saved
    bnd = bound(4 * m * n + 8 * m * k, (m * n, FP32_FLOPS))
    phase("kernels", kernel=name, shape=[m, n, k], id_agreement=agree,
          max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bnd[0], bound_by=bnd[1])
    return kernel_row(name, "raft_tpu_torch/csrc/select_k.cu",
                      "raft_tpu/ops/pallas_select_k.py:47", max_abs, ms,
                      plain_ms, bnd, lib_ms)


def quality_burst(srv, q_np):
    """One burst through ``srv``, then the monitor drained: (QPS, p50 ms,
    p99 ms, drain seconds)."""
    _, _, lat, wall = serve_burst(srv, q_np)
    t0 = time.perf_counter()
    if srv.quality is not None and not srv.quality.drain(600.0):
        fail("serve_quality: the shadow thread did not drain in 600 s")
    p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
    return N_REQUESTS / wall, p50, p99, time.perf_counter() - t0


def run_serve_quality(index, q_np, truth, n_rows: int, main: dict):
    """Phase 3 ``serve_quality``: the served burst with every query
    sampled into a ``QualityMonitor`` whose exact scorer covers all
    ``n_rows`` rows of the index (kernel 2 once a 65536-row chunk and
    32-query batch, on the monitor's own stream), drained; the monitor's
    recall against the burst's own; the scorer against the exact truth;
    kernel 2 at the scorer's tile. Then rounds of the same burst with
    sampling off, on the shadow stream and on the default stream, for
    their QPS and p99, with tracing off. Returns the ``select_k@quality``
    row."""
    from raft_tpu_torch import obs, ops
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.obs.quality import QualityConfig, corpus_from_index
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    params = ivf_flat.SearchParams(n_probes=N_PROBES)
    cfg = dict(batch_sizes=BATCH_SIZES, max_queue=512, max_wait_ms=2.0)
    t0 = time.perf_counter()
    corpus, ids = corpus_from_index(index)
    corpus_s = time.perf_counter() - t0
    if corpus.shape != (n_rows, D) or ids.shape != (n_rows,):
        fail(f"serve_quality: corpus_from_index gave {corpus.shape}")
    off = SearchServer.from_index(index, q_np[:128], K, params=params,
                                  config=ServeConfig(**cfg))
    try:
        if off.enable_quality(corpus, ids) is not None or \
                off.quality is not None:
            fail("serve_quality: a rate-0 server attached a monitor")
    finally:
        off.close()
    del off
    ops.reset_launch_counts()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=params,
        config=ServeConfig(quality_sample_rate=1.0, **cfg))
    try:
        t0 = time.perf_counter()
        mon = srv.enable_quality(corpus, ids, qconfig=QualityConfig(
            max_rows=n_rows, window=1024, max_pending=1024))
        scorer_s = time.perf_counter() - t0
        del corpus, ids
        scorer = mon.scorer
        if scorer.sampled or scorer.rows != n_rows:
            fail(f"serve_quality: the scorer holds {scorer.rows} rows")
        loaded = _build.loaded()
        before = obs.snapshot()
        served_d, served, lat, wall = serve_burst(srv, q_np)
        burst = ops.launch_counts()
        t0 = time.perf_counter()
        if not mon.drain(600.0):
            fail("serve_quality: the shadow thread did not drain in 600 s")
        drain_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        after = obs.snapshot()
        deltas = counter_deltas(before, after, "raft.obs.quality.")
        check_launched("serve_quality", launches, ("select_k", "ivf_scan"))
        stats = mon.stats()
        hits = [len(set(served[r]) & set(truth[r % N_QUERIES]))
                for r in range(N_REQUESTS)]
        burst_recall = float(np.mean(hits)) / K
        if _build.loaded() != loaded:
            fail(f"serve_quality: kernel libraries loaded while sampling: "
                 f"{sorted(set(_build.loaded()) - set(loaded))}")
        moved = {n: obs.counter_sum(after, f"raft.obs.quality.{n}.total")
                 - obs.counter_sum(before, f"raft.obs.quality.{n}.total")
                 for n in ("samples", "errors")}
        if moved != {"samples": N_REQUESTS, "errors": 0}:
            fail(f"serve_quality: the counters moved {deltas}, not "
                 f"{N_REQUESTS} samples and no error")
        if stats["recall"] is None or \
                abs(stats["recall"] - burst_recall) > 0.002:
            fail(f"serve_quality: monitor recall {stats['recall']} against "
                 f"the burst's {burst_recall}")
        # the scorer against the exact truth, timed a 32-query batch
        sel0 = ops.launch_counts()["select_k"]
        t0 = time.perf_counter()
        exact = scorer.topk(q_np[:N_QUERIES], K)
        batches = -(-N_QUERIES // scorer.batch)
        batch_s = (time.perf_counter() - t0) / batches
        per_batch = (ops.launch_counts()["select_k"] - sel0) / batches
        agree = float((exact == truth[:N_QUERIES]).mean())
        if agree < MIN_ID_AGREEMENT:
            fail(f"serve_quality: scorer ids agree with the truth on "
                 f"{agree:.5f} < {MIN_ID_AGREEMENT}")
        row = check_select_k_tile(scorer, q_np, "select_k@quality")
        row["launches"] = launches["select_k"]
        # sampling off (the one flag cleared), the shadow on its stream,
        # the shadow on the default stream: rounds in turn
        side = mon._stream
        modes = {"off": None, "shadow_stream": side,
                 "default_stream": torch.cuda.default_stream(
                     scorer.device)}
        ab = {m: [] for m in modes}
        # tracing off in the rounds, so that they compare with a tree
        # that has none
        spans.set_trace_enabled(False)
        for rnd in range(QUALITY_ROUNDS):
            order = list(modes)[rnd % len(modes):] + \
                list(modes)[:rnd % len(modes)]
            for mode in order:
                if mode == "off":
                    srv._quality = None
                else:
                    mon._stream = modes[mode]
                ab[mode].append(quality_burst(srv, q_np))
                srv._quality = mon
        mon._stream = side
    finally:
        spans.set_trace_enabled(True)
        srv.close()
    ab_med = {m: dict(zip(("qps", "p50_ms", "p99_ms", "drain_s"),
                          np.median(np.asarray(v), axis=0).tolist()))
              for m, v in ab.items()}
    p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
    phase("serve_quality", rate=1.0, rows=n_rows,
          chunks=len(scorer._chunks), corpus_s=corpus_s,
          scorer_construct_s=scorer_s, qps=N_REQUESTS / wall, p50_ms=p50,
          p99_ms=p99, burst_recall=burst_recall, monitor=stats,
          main_burst={k_: main[k_] for k_ in ("qps", "p50_ms", "p99_ms")},
          drain_s=drain_s, burst_launches=burst, launches=launches,
          select_k_during_drain=launches["select_k"] - burst["select_k"],
          select_k_per_shadow_batch=per_batch, shadow_batch_s=batch_s,
          scorer_id_agreement=agree, quality_counters=deltas,
          rounds=QUALITY_ROUNDS, ab_median=ab_med, ab=ab)
    del mon, scorer, srv
    free_phase("serve_quality")
    return row


OBS_ROUNDS = 9
# chrome-trace nesting slack (us): span times are rounded to 1 us
NEST_SLACK_US = 2.0
# a dispatch's device half (two events around its work) against the
# wall of its plan.search span, which holds both events (ms; both are
# rounded to 1 us)
DEVICE_SLACK_MS = 0.01
# the profiler's device share of a traced burst against the trace's busy
# share: every kernel of a dispatch runs between its events, so the
# device share lies at or above the busy share (the burst's few copies
# outside the plan aside)
BUSY_SHARE_FLOOR = 0.9


def obs_burst(srv, q_np):
    """One burst: (QPS, p50 ms, p99 ms)."""
    _, _, lat, wall = serve_burst(srv, q_np)
    p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
    return N_REQUESTS / wall, p50, p99


def check_nesting(trace: dict) -> int:
    """``to_chrome_trace`` of ``trace`` through JSON and back; every
    span opened inside another lies within it (a batch's queue waits
    aside: they are recorded after the fact from admission, before the
    batch span opened). Returns the events checked."""
    from raft_tpu_torch import obs
    chrome = json.loads(json.dumps(obs.to_chrome_trace(trace)))
    ev = {e["args"]["span_id"]: e for e in chrome["traceEvents"]
          if e.get("ph") == "X"}
    n = 0
    for e in ev.values():
        parent = ev.get(e["args"].get("parent_id"))
        if parent is None or (e["name"] == "raft.serve.queue_wait"
                              and parent["name"] == "raft.serve.batch"):
            continue
        n += 1
        if e["ts"] < parent["ts"] - NEST_SLACK_US or \
                e["ts"] + e["dur"] > parent["ts"] + parent["dur"] + \
                NEST_SLACK_US:
            fail(f"serve_obs: span {e['name']} lies outside its parent "
                 f"{parent['name']} in the Chrome trace")
    return n


def check_batch_tree(trace: dict) -> None:
    """The reference batcher's tree: raft.serve.execute ->
    raft.plan.search -> raft.obs.profile.sync, the sync's device half
    (between two events) inside the plan.search span's wall."""
    from raft_tpu_torch.obs import profiler
    by_id = {s["span_id"]: s for s in trace["spans"]}
    sync = [s for s in trace["spans"] if s["name"] == profiler.SYNC_SPAN]
    if len(sync) != 1:
        fail(f"serve_obs: a batch trace holds {len(sync)} sync spans")
    chain = [by_id.get(sync[0]["parent_id"])]
    chain.append(by_id.get(chain[0]["parent_id"]) if chain[0] else None)
    if [c and c["name"] for c in chain] != ["raft.plan.search",
                                           "raft.serve.execute"]:
        fail(f"serve_obs: the sync span hangs under "
             f"{[c and c['name'] for c in chain]}")
    device_ms = sync[0]["attrs"]["device_ms"]
    if not 0.0 < device_ms <= chain[0]["duration_ms"] + DEVICE_SLACK_MS:
        fail(f"serve_obs: a dispatch's device half {device_ms} ms against "
             f"its plan.search wall {chain[0]['duration_ms']} ms")


def run_serve_obs(index, q_np, truth, main: dict) -> None:
    """Phase 3 ``serve_obs``: the burst with the observability core off,
    then on at full rate (gated), then rounds of off / tracing / tracing
    and the profiler sampled / both full in turn (recorded, not gated),
    then one burst at full rate traced by ``torch.profiler``, where the
    profiler's device share must lie between the trace's busy share and
    1."""
    from raft_tpu_torch import obs, ops
    from raft_tpu_torch.core import memory
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import profiler, spans
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    cfg = ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                      max_wait_ms=2.0)
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=ivf_flat.SearchParams(n_probes=N_PROBES),
        config=cfg)
    rec = obs.RECORDER

    def modes(trace: bool, rate: float):
        spans.set_trace_enabled(trace)
        spans.set_trace_sample_rate(1.0)
        if rate > 0:
            profiler.enable_profiling(rate, seed=0)
        else:
            profiler.disable_profiling()

    try:
        # 1. everything off
        modes(False, 0.0)
        rec.clear()
        off = obs_burst(srv, q_np)
        threads = [t.name for t in threading.enumerate()
                   if t.name == "raft-obs-profiler"]
        if profiler.state() is not None or threads or len(rec):
            fail(f"serve_obs: off, yet profiler {profiler.state()}, "
                 f"threads {threads}, {len(rec)} traces recorded")
        # 2. tracing and the profiler at 1.0
        modes(True, 1.0)
        ops.reset_launch_counts()
        before = obs.snapshot()
        t0 = time.perf_counter()
        served_d, served, lat, wall = serve_burst(srv, q_np)
        after = obs.snapshot()
        launches = ops.launch_counts()
        diff = obs.snapshot_diff(before, after)
        hist = diff["histograms"]
        ctr = diff["counters"]
        counts = {n: hist.get(f"raft.serve.{n}", {}).get("count", 0)
                  for n in ("request.seconds", "queue.delay.seconds")}
        if counts != {n: N_REQUESTS for n in counts}:
            fail(f"serve_obs: histogram counts {counts}")
        size = hist.get("raft.serve.batch.size", {"count": 0, "sum": 0})
        batches = obs.counter_sum(diff, "raft.serve.batch.total")
        if size["count"] != batches or \
                size["sum"] != ctr.get("raft.serve.batch.rows", -1):
            fail(f"serve_obs: batch.size {size} against {batches} batches "
                 f"of {ctr.get('raft.serve.batch.rows')} rows")
        samples = obs.counter_sum(diff, "raft.obs.profile.samples.total")
        searches = ctr.get("raft.plan.search.total", 0)
        if samples != searches or samples <= 0:
            fail(f"serve_obs: {samples} profiler samples for {searches} "
                 f"blocking plan.search calls")
        # a batch's request traces are recorded after its batch trace, so
        # when the burst's last batch holds 128 requests they alone fill
        # the 128-trace ring: one more 128-row request (one batch, one
        # request trace) puts a batch trace of the list-major plan among
        # the newest entries whatever the burst's batching
        srv.search(q_np[:128], timeout=600)
        traces = rec.requests()
        batch_traces = [t for t in traces if t["name"] == "raft.serve.batch"]
        if len(traces) != rec.capacity or not batch_traces:
            fail(f"serve_obs: the ring holds {len(traces)} traces "
                 f"({len(batch_traces)} batches), capacity {rec.capacity}")
        for t in batch_traces:
            check_batch_tree(t)
        nested = check_nesting(batch_traces[0])
        req_traces = [t for t in traces if t["name"] == "raft.serve.request"]
        if not req_traces:
            fail("serve_obs: the ring holds no request trace")
        nested += check_nesting(req_traces[0])
        report = profiler.report()
        # the gauge clamps at 1: the report's device seconds, rate and
        # window give the value before the clamp
        duty = report["device_s"] / report["rate"] / report["window_s"]
        if not 0.0 < duty <= 1.05:
            fail(f"serve_obs: duty cycle {duty} before the clamp")
        st = profiler.state()
        st._sample_hbm(memory)
        gauges = obs.snapshot()["gauges"]
        label = f"cuda:{torch.cuda.current_device()}"
        hbm = {n: gauges.get(f"raft.obs.profile.hbm.{n}{{device={label}}}")
               for n in ("bytes_in_use", "limit_bytes", "headroom_frac")}
        allocated = torch.cuda.memory_allocated()
        if hbm["bytes_in_use"] != allocated or \
                hbm["limit_bytes"] != torch.cuda.mem_get_info()[1] or \
                gauges.get("raft.obs.profile.hbm.low_headroom") != 0:
            fail(f"serve_obs: memory gauges {hbm}, allocated {allocated}")
        check_launched("serve_obs", launches, ("select_k", "ivf_scan"))
        hits = [len(set(served[r]) & set(truth[r % N_QUERIES]))
                for r in range(N_REQUESTS)]
        recall = float(np.mean(hits)) / K
        if recall < RECALL_FLOOR:
            fail(f"serve_obs: recall@{K} = {recall}")
        p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
        full = (N_REQUESTS / wall, p50, p99)
        prog = report["programs"][0] if report["programs"] else {}
        split = {"samples": report["samples"],
                 "host_ms_per_dispatch": report["host_s"] * 1e3
                 / max(report["samples"], 1),
                 "device_ms_per_dispatch": report["device_s"] * 1e3
                 / max(report["samples"], 1),
                 "top_program": prog}
        # 3. rounds in turn, recorded
        mode_set = {"off": (False, 0.0), "trace": (True, 0.0),
                    "sampled": (True, 0.01), "full": (True, 1.0)}
        ab = {m: [] for m in mode_set}
        for rnd in range(OBS_ROUNDS):
            r = rnd % len(mode_set)
            for m in list(mode_set)[r:] + list(mode_set)[:r]:
                modes(*mode_set[m])
                ab[m].append(obs_burst(srv, q_np))
        # 4. the profiler's device share against torch.profiler's busy
        # share of the same burst
        modes(True, 1.0)
        walls, reps = [], []

        def traced():
            walls.append(serve_burst(srv, q_np)[-1])
            # the report at once: the trace's own processing follows
            reps.append(profiler.report())
            return walls[-1]

        busy_share = profile_run(traced, "serve_obs",
                                 "profile_burst_serve_obs")
        rep = reps[0]
        device_share = rep["device_s"] / walls[0]
        if not BUSY_SHARE_FLOOR * busy_share <= device_share <= 1.05:
            fail(f"serve_obs: the profiler's device share {device_share} "
                 f"against the trace's busy share {busy_share}")
        busy = {"busy_share": busy_share, "device_share": device_share,
                "duty_cycle": rep["device_s"] / rep["rate"]
                / rep["window_s"], "samples": rep["samples"],
                "host_ms_per_dispatch": rep["host_s"] * 1e3
                / max(rep["samples"], 1),
                "device_ms_per_dispatch": rep["device_s"] * 1e3
                / max(rep["samples"], 1)}
    finally:
        srv.close()
        profiler.disable_profiling()
        spans.set_trace_enabled(True)
    ab_med = {m: dict(zip(("qps", "p50_ms", "p99_ms"),
                          np.median(np.asarray(v), axis=0).tolist()))
              for m, v in ab.items()}
    # the QPS each mode loses against everything off, round by round
    # (the modes take turns) and the median of it
    qps_loss = {m: float(np.median([1.0 - v[0] / o[0] for v, o in
                                    zip(ab[m], ab["off"])]))
                for m in ab if m != "off"}
    phase("serve_obs", off=dict(zip(("qps", "p50_ms", "p99_ms"), off)),
          full=dict(zip(("qps", "p50_ms", "p99_ms"), full)),
          main_burst={k_: main[k_] for k_ in ("qps", "p50_ms", "p99_ms")},
          recall=recall, histograms={k_: {"count": v["count"],
                                         "sum": v["sum"]}
                                     for k_, v in hist.items()
                                     if k_.startswith("raft.serve.")},
          batches=batches, profile_samples=samples, ring=len(traces),
          batch_traces_checked=len(batch_traces), nested_spans=nested,
          duty_cycle=duty, split=split, hbm=hbm,
          launches={k_: v for k_, v in launches.items() if v},
          burst_s=time.perf_counter() - t0, rounds=OBS_ROUNDS,
          ab_median=ab_med, qps_loss=qps_loss, ab=ab, profile=busy)
    del srv
    free_phase("serve_obs")


def mixture_rows(n: int, m: int, seed: int, draw_seed: int, dev):
    """``m`` more rows of ``ann_dataset(n, D, ..., seed)``'s mixture (its
    centres, the generator's first draw), drawn from ``draw_seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nc = max(64, min(8192, n // 125))
    centers = torch.randn((nc, D), generator=g, device=dev)
    g = torch.Generator(device=dev).manual_seed(draw_seed)
    lab = torch.randint(0, nc, (m,), generator=g, device=dev)
    return centers[lab] + torch.randn((m, D), generator=g, device=dev)


@contextlib.contextmanager
def timed_parts(targets):
    """Wrap each ``(owner, attribute, part)`` callable so that its calls
    add their host seconds to ``parts[part]`` (and count in
    ``calls[part]``) inside the scope."""
    parts = {p: 0.0 for _, _, p in targets}
    calls = dict.fromkeys(parts, 0)
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    for (owner, attr, part), (_, _, fn) in zip(targets, saved):
        def wrapped(*a, _fn=fn, _part=part, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                parts[_part] += time.perf_counter() - t0
                calls[_part] += 1
        setattr(owner, attr, wrapped)
    try:
        yield parts, calls
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def mutate_writer(m, new_rows, del_ids, re_ids, re_rows, errors):
    """The writer of ``serve_mutate``: upserts of ``new_rows``, with a
    delete batch of ``del_ids`` after every third and a re-upsert batch
    of ``re_ids`` after the middle and the last, ``MUTATE_PACE_S``
    apart → the ids the upserts got (in order)."""
    got = []
    b = MUTATE_BATCH
    n_up = len(new_rows) // b
    dels = iter(range(0, len(del_ids), b))
    res = iter(range(0, len(re_ids), b))
    try:
        for j in range(n_up):
            got.append(m.upsert(new_rows[j * b:(j + 1) * b]))
            if j % 3 == 2:
                s = next(dels, None)
                if s is not None:
                    m.delete(del_ids[s:s + b])
            if j in (n_up // 2 - 1, n_up - 1):
                s = next(res, None)
                if s is not None:
                    m.upsert(re_rows[s:s + b], ids=re_ids[s:s + b])
            time.sleep(MUTATE_PACE_S)
    except Exception as e:  # reported after the join
        errors.append(repr(e))
    return got


def search_all(m, queries, batch: int = 128) -> np.ndarray:
    """Every row of ``queries`` through ``m.search`` in full batches of
    ``batch`` (the last padded with its own first rows) → ids."""
    out = []
    for s in range(0, queries.shape[0], batch):
        qb = queries[s:s + batch]
        n = qb.shape[0]
        if n < batch:
            qb = torch.cat([qb, qb[:1].expand(batch - n, -1)])
        out.append(m.search(qb, block=True)[1][:n].cpu().numpy())
    return np.concatenate(out)


def run_serve_mutate(index, x, q, q_np, main: dict, seed: int):
    """Phase 3 ``serve_mutate``: the index wrapped as a ``MutableIndex``
    (the default ``MutateConfig``) behind ``SearchServer.from_index`` and
    a ``Compactor``; bursts run while a writer upserts, deletes and
    re-upserts, until the writer and the compactor are quiet. Checks: no
    request fails, every plan-cache miss of the run is a compaction's
    warm-up of the next epoch (the serving path prepares nothing), the
    epoch has rolled; then serially: no deleted id comes back, each
    upserted row finds itself at rank 0, the server's ids equal a direct
    search, kernels 1 (in the fold), 2 (column and payload) and 3 were
    launched. Recorded: recall@K of the live view against an exact search
    of the live corpus, QPS and latency beside the main burst's, the
    fold's host seconds by part and device memory. Returns the rows
    ``select_k@mutate`` (the delta top-k at the top rung) and
    ``select_k_payload@mutate`` (the merge)."""
    from raft_tpu_torch import mutate, obs, ops
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.mutate import compact as compact_mod
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    n, dev = x.shape[0], x.device
    gen = np.random.default_rng(seed + 101)
    picked = gen.choice(n, MUTATE_DELETES + MUTATE_REUPSERTS, replace=False)
    re_ids = picked[:MUTATE_REUPSERTS].astype(np.int32)
    del_ids = picked[MUTATE_REUPSERTS:].astype(np.int64)
    new_rows = mixture_rows(n, MUTATE_UPSERTS, seed, seed + 102, dev)
    re_rows = mixture_rows(n, MUTATE_REUPSERTS, seed, seed + 103, dev)
    new_np, re_np = new_rows.cpu().numpy(), re_rows.cpu().numpy()
    params = ivf_flat.SearchParams(n_probes=N_PROBES)
    m = mutate.MutableIndex(index, k=K, params=params)
    cfg = m.cfg
    t0 = time.perf_counter()
    srv = SearchServer.from_index(m, q_np[:128], K, config=ServeConfig(
        batch_sizes=BATCH_SIZES, max_queue=512, max_wait_ms=2.0))
    ladder_s = time.perf_counter() - t0
    grid = len(BATCH_SIZES) * len(cfg.delta_capacities)
    comp = mutate.Compactor(m)
    errors, got = [], []
    gc.collect()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    before = obs.snapshot()
    rounds = []
    try:
        with timed_parts([(compact_mod, "purge", "purge"),
                          (ivf_flat, "extend", "extend"),
                          (mutate.MutableIndex, "_prewarm_epoch", "prewarm"),
                          (mutate.MutableIndex, "_swap_epoch", "swap")]
                         ) as (parts, calls):
            writer = threading.Thread(target=lambda: got.extend(mutate_writer(
                m, new_np, del_ids, re_ids, re_np, errors)), daemon=True)
            writer.start()
            deadline = time.perf_counter() + MUTATE_TIMEOUT_S
            while True:
                rounds.append(serve_burst(srv, q_np))
                quiet = (not writer.is_alive() and m.epoch >= 1
                         and not m.stats()["compacting"]
                         and not m.should_compact())
                if quiet and len(rounds) >= 2:
                    break
                if time.perf_counter() > deadline:
                    fail(f"serve_mutate: not quiet after {len(rounds)} "
                         f"bursts: {m.stats()}")
            writer.join(timeout=60)
        comp.close()
        after = obs.snapshot()
        launches = ops.launch_counts()
        mem_peak = torch.cuda.max_memory_allocated()
        if writer.is_alive() or errors:
            fail(f"serve_mutate: the writer failed: {errors[:1]}")
        deltas = counter_deltas(before, after, "raft.")
        rows_in = (deltas.get("raft.mutate.upserts.rows", 0),
                   deltas.get("raft.mutate.deletes.rows", 0))
        if rows_in != (MUTATE_UPSERTS + MUTATE_REUPSERTS, MUTATE_DELETES):
            fail(f"serve_mutate: the writer applied {rows_in} rows")
        folds = int(deltas.get("raft.mutate.compact.total", 0))
        misses = int(deltas.get("raft.plan.cache.misses", 0))
        if folds < 1 or m.epoch < 1:
            fail(f"serve_mutate: no fold ran under traffic (epoch "
                 f"{m.epoch})")
        if misses != folds * grid or calls["prewarm"] != folds:
            fail(f"serve_mutate: {misses} plan-cache misses over {folds} "
                 f"folds, not the {grid} warm-ups of each next epoch: the "
                 f"serving path prepared a program")
        next_id = m.stats()["next_id"]
        for served_d, served, _, _ in rounds:
            if served.shape != (N_REQUESTS, K) or (served < 0).any() or                     (served >= next_id).any():
                fail("serve_mutate: served ids out of range")
            if not np.isfinite(served_d).all() or                     (np.diff(served_d, axis=1) < 0).any():
                fail("serve_mutate: served distances are not finite and "
                     "ascending")
        check_launched("serve_mutate", launches,
                       ("fused_l2_nn", "select_k", "select_k_payload",
                        "ivf_scan"))
        # serial checks on the quiet index
        t0 = time.perf_counter()
        up_ids = np.concatenate(got)
        if up_ids.shape[0] != MUTATE_UPSERTS:
            fail(f"serve_mutate: {up_ids.shape[0]} upserts acknowledged")
        self_new = search_all(m, new_rows)[:, 0] == up_ids
        self_re = search_all(m, re_rows)[:, 0] == re_ids
        self_hit = float(np.concatenate([self_new, self_re]).mean())
        if self_hit < MUTATE_SELF_HIT:
            fail(f"serve_mutate: upserted rows find themselves at rank 0 "
                 f"on {self_hit:.5f} < {MUTATE_SELF_HIT}")
        dead = search_all(m, x[torch.from_numpy(del_ids).to(dev)])
        if np.isin(dead, del_ids).any():
            fail(f"serve_mutate: {int(np.isin(dead, del_ids).sum())} "
                 f"deleted ids returned")
        srv_d, srv_i = srv.search(q_np[:128], timeout=600)
        dir_d, dir_i = m.search(q[:128], block=True)
        if not np.array_equal(srv_i, dir_i.cpu().numpy()):
            fail("serve_mutate: the server's ids differ from a direct "
                 "search of the same batch")
        serial_s = time.perf_counter() - t0
        # recall@K of the live view against the live corpus's exact top-K
        keep = torch.ones(n, dtype=torch.bool, device=dev)
        keep[torch.from_numpy(picked).to(dev)] = False
        live = torch.cat([x[keep], re_rows, new_rows])
        live_ids = np.concatenate([np.flatnonzero(keep.cpu().numpy()),
                                   re_ids, up_ids])
        truth_live = live_ids[brute_force_knn(
            live, q, K, DistanceType.L2Expanded, mode="exact",
            device=dev)[1].cpu()
            .numpy()]
        del live, keep
        got_live = m.search(q, block=True)[1].cpu().numpy()
        recall = float(np.mean([len(set(got_live[r]) & set(truth_live[r]))
                                for r in range(N_QUERIES)])) / K
        if recall < RECALL_FLOOR:
            fail(f"serve_mutate: live recall@{K} = {recall}")
        rows = mutate_tail_rows(m, q[:128].contiguous(),
                                torch.cat([new_rows, re_rows]),
                                np.concatenate([up_ids, re_ids]), params,
                                launches)
        st = m.stats()
    finally:
        comp.close()
        srv.close()
    lat = np.concatenate([r[2] for r in rounds])
    wall = sum(r[3] for r in rounds)
    p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
    phase("serve_mutate", n=n, upserts=MUTATE_UPSERTS,
          deletes=MUTATE_DELETES, reupserts=MUTATE_REUPSERTS,
          batch=MUTATE_BATCH, delta_capacities=list(cfg.delta_capacities),
          ladder_s=ladder_s, bursts=len(rounds), requests=len(lat),
          qps=len(lat) / wall, p50_ms=p50, p99_ms=p99,
          burst_qps=[N_REQUESTS / r[3] for r in rounds],
          main_burst={k_: main[k_] for k_ in ("qps", "p50_ms", "p99_ms")},
          folds=folds, plan_cache_misses=misses, warmups_per_fold=grid,
          fold_s=parts, fold_calls=calls, epoch=st["epoch"], stats=st,
          **{f"live_recall_at_{K}": recall}, self_hit_rank0=self_hit,
          deleted_returned=0, serial_s=serial_s,
          mem_before_gb=mem_before / 1e9, mem_peak_gb=mem_peak / 1e9,
          mem_after_gb=torch.cuda.memory_allocated() / 1e9,
          mutate_counters={k_: v for k_, v in deltas.items()
                           if k_.startswith("raft.mutate.")},
          launches=launches)
    del m, srv, comp
    free_phase("serve_mutate")
    return rows


def batched(fn, q, batch: int = 128):
    """``fn(q_slice) -> (dists, ids)`` over ``q`` in slices of ``batch``
    rows → (dists, ids) as numpy."""
    outs = [fn(q[s:s + batch]) for s in range(0, q.shape[0], batch)]
    return (np.concatenate([o[0].cpu().numpy() for o in outs]),
            np.concatenate([o[1].cpu().numpy() for o in outs]))


def tier_burst(srv, q_np, truth, n_rows: int):
    """One burst through a tiered server: serve_phase's fields plus the
    burst's hit rate (hot probes over all probes) and the
    ``raft.tiered.*`` counter deltas."""
    from raft_tpu_torch import obs
    before = obs.snapshot()
    served = serve_phase(srv, q_np, truth, n_rows, close=False)
    after = obs.snapshot()
    tier = counter_deltas(before, after, "raft.tiered.")
    probes = tier.get("raft.tiered.probes.hot", 0) + \
        tier.get("raft.tiered.probes.cold", 0)
    served["hit_rate"] = (tier.get("raft.tiered.probes.hot", 0) / probes
                          if probes else 0.0)
    fetch_s = tier.get("raft.tiered.fetch.seconds", 0)
    served["overlap_frac"] = (tier.get("raft.tiered.overlap.seconds", 0)
                              / fetch_s if fetch_s else 0.0)
    served["tiered"] = tier
    return served


def run_serve_tiered(index, x, q, q_np, truth, main: dict):
    """Phase 3 ``serve_tiered`` on the main IVF-Flat index: its lists to
    host memory (``to_host``), a ``TieredIndex`` (hot_frac 0.3: the
    256-list rung; staging chunks of at most 256 lists), the 256 queries
    at 128 a batch through a tiered plan and ``host_memory.search``
    against the resident probe-order search (ids equal, distances within
    rtol 1e-5); a ``SearchServer`` burst (QPS, latency, recall@K, the
    ``raft.tiered.*`` deltas; the served ids a direct plan's), a
    ``refresh()`` and a second burst, a refresh at half the budget
    (demotions, ids unchanged); then ``host_memory.build_streaming`` of
    every row in 1M-row host chunks (seconds, peak device bytes above the
    baseline under half the corpus, recall@K of its host search). Rows
    ``select_k@tiered`` (the coarse select at (128, 1024) k=96),
    ``select_k_payload@tiered`` (the tier merge's (128, 64) candidates at
    k=32) and ``fused_l2_nn@stream`` (kernel 1 at a chunk's shape)."""
    from raft_tpu_torch import obs, ops
    from raft_tpu_torch.neighbors import host_memory, ivf_flat, tiered
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    n, dev = x.shape[0], x.device
    sp = ivf_flat.SearchParams(n_probes=N_PROBES, scan_order="probe")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    d_res, i_res = batched(lambda qb: ivf_flat.search(index, qb, K, sp), q)
    resident_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = host_memory.to_host(index)
    to_host_s = time.perf_counter() - t0
    host_bytes = (host.lists_data.nbytes + host.lists_norms.nbytes
                  + host.lists_indices.nbytes)
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ti = tiered.from_host(host, tiered.TieredConfig(
        hot_frac=TIER_HOT_FRAC, max_stage_lists=TIER_STAGE_LISTS))
    tier_s = time.perf_counter() - t0
    placed = {"hot_cap": ti._hot_cap, "hot_lists": ti.hot_lists,
              "budget_bytes": ti.budget_bytes,
              "bytes_per_list": ti.bytes_per_list,
              "hot_table_gb": ti.table_bytes(ti._hot_cap) / 1e9,
              "stage_capacities": list(ti.stage_capacities),
              "hot_mem_gb": (torch.cuda.memory_allocated() - mem_before)
              / 1e9}
    if ti._hot_cap != TIER_HOT_RUNG:
        fail(f"serve_tiered: hot rung {ti._hot_cap}, not {TIER_HOT_RUNG}")
    plan = tiered.build_plan(ti, q_np[:128], K, sp)
    merges = []
    real_merge = tiered._merge_topk

    def keep_merge(*a):
        merges.append(a)
        return real_merge(*a)

    tiered._merge_topk = keep_merge
    try:
        t0 = time.perf_counter()
        d_t, i_t = batched(lambda qb: plan.search(qb, block=True), q)
        plan_s = time.perf_counter() - t0
    finally:
        tiered._merge_topk = real_merge
    if not np.array_equal(i_t, i_res):
        fail(f"serve_tiered: tiered ids differ from the resident "
             f"probe-order search on {int((i_t != i_res).sum())} entries")
    if not np.allclose(d_t, d_res, rtol=RTOL, atol=RTOL):
        fail("serve_tiered: tiered distances differ from the resident "
             "search's")
    t0 = time.perf_counter()
    i_h = batched(lambda qb: host_memory.search(host, qb, K, sp), q)[1]
    host_s = time.perf_counter() - t0
    if not np.array_equal(i_h, i_res):
        fail("serve_tiered: host_memory ids differ from the resident "
             "search's")
    # the tier merge's candidates of the last 128-query batch, for the
    # payload select's row
    d_a, i_a, d_b, i_b, _ = merges[-1]
    merge_d = torch.cat([d_a, d_b], 1).contiguous()
    merge_i = torch.cat([i_a, i_b], 1).to(torch.int32).contiguous()
    del merges

    srv = SearchServer.from_index(ti, q_np[:128], K, params=sp,
                                  config=ServeConfig(
                                      batch_sizes=BATCH_SIZES,
                                      max_queue=512, max_wait_ms=2.0))
    try:
        first = tier_burst(srv, q_np, truth, n)
        srv_i = srv.search(q_np[:128], timeout=600)[1]
        if not np.array_equal(srv_i, plan.search(q[:128], block=True)[1]
                              .cpu().numpy()):
            fail("serve_tiered: the server's ids differ from a direct "
                 "plan's")
        t0 = time.perf_counter()
        refreshed = ti.refresh()
        refresh_s = time.perf_counter() - t0
        second = tier_burst(srv, q_np, truth, n)
    finally:
        srv.close()
    half = ti.refresh(budget_bytes=ti.budget_bytes // 2)
    if half["demoted"] <= 0:
        fail(f"serve_tiered: a refresh at half the budget demoted "
             f"nothing: {half}")
    i_half = batched(lambda qb: plan.search(qb, block=True), q)[1]
    if not np.array_equal(i_half, i_res):
        fail("serve_tiered: ids changed after the demotion")
    gauges = {k_: v for k_, v in obs.snapshot()["gauges"].items()
              if k_.startswith("raft.tiered.")}
    launches_serve = ops.launch_counts()
    del plan, srv, ti, host, d_t, i_t
    gc.collect()

    # the streaming build of every row from host chunks
    x_np = x.cpu().numpy()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    nn_before = dict(l2nn_shapes())
    t0 = time.perf_counter()
    hs = host_memory.build_streaming(
        (x_np[s:s + STREAM_CHUNK] for s in range(0, n, STREAM_CHUNK)),
        ivf_flat.IndexParams(n_lists=N_LISTS, kmeans_n_iters=KMEANS_ITERS),
        device=dev)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_peak = torch.cuda.max_memory_allocated() - base
    stream_shapes = {k_: v - nn_before.get(k_, 0)
                     for k_, v in l2nn_shapes().items()
                     if v != nn_before.get(k_, 0)}
    if stream_peak >= 0.5 * x.numel() * 4:
        fail(f"serve_tiered: the streaming build peaked {stream_peak} "
             f"bytes above its baseline, not under half the corpus")
    if hs.size != n or int((hs.lists_indices >= 0).sum()) != n:
        fail(f"serve_tiered: the streaming build holds "
             f"{int((hs.lists_indices >= 0).sum())} of {n} rows")
    t0 = time.perf_counter()
    i_s = batched(lambda qb: host_memory.search(hs, qb, K, sp), q)[1]
    stream_search_s = time.perf_counter() - t0
    stream_recall = float(np.mean([len(set(i_s[r]) & set(truth[r]))
                                   for r in range(N_QUERIES)])) / K
    if stream_recall < RECALL_FLOOR:
        fail(f"serve_tiered: streaming build recall@{K} = {stream_recall}")
    launches = ops.launch_counts()
    check_launched("serve_tiered", launches,
                   ("fused_l2_nn", "select_k", "select_k_payload"))
    chunk_key = f"{min(n, STREAM_CHUNK)}x{N_LISTS}"
    phase("serve_tiered", n=n, n_lists=N_LISTS, n_probes=N_PROBES, k=K,
          to_host_s=to_host_s, host_gb=host_bytes / 1e9, tier_s=tier_s,
          **placed, resident_probe_s=resident_s, tiered_plan_s=plan_s,
          host_memory_s=host_s, ids_equal_resident=True,
          burst=first, refresh=refreshed, refresh_s=refresh_s,
          burst_after_refresh=second,
          hit_rates=[first["hit_rate"], second["hit_rate"]],
          half_budget=half, ids_equal_after_demotion=True, gauges=gauges,
          main_burst={k_: main[k_] for k_ in ("qps", "p50_ms", "p99_ms")},
          launches_serving=launches_serve, stream_chunk=STREAM_CHUNK,
          stream_s=stream_s, stream_peak_gb=stream_peak / 1e9,
          corpus_gb=x.numel() * 4 / 1e9,
          stream_fused_l2_nn_shapes=stream_shapes,
          stream_search_s=stream_search_s,
          **{f"stream_recall_at_{K}": stream_recall}, launches=launches)
    nn_row = check_fused_l2_nn(x[:STREAM_CHUNK].contiguous(),
                               hs.centers.contiguous(),
                               "fused_l2_nn@stream")
    nn_row["launches"] = stream_shapes.get(chunk_key, 0)
    del hs, x_np
    sel_row = check_select_k(q, index.centers, N_PROBES, "select_k@tiered")
    sel_row["launches"] = launches["select_k"]
    pay_row = check_pass_b("select_k_payload@tiered", merge_d, merge_i, K,
                           launches["select_k_payload"],
                           "raft_tpu/ops/pallas_select_k.py:47")
    free_phase("serve_tiered")
    return [sel_row, pay_row, nn_row]


def durable_writes(m, new_rows, del_ids, re_ids, re_rows):
    """``mutate_durable``'s writer, serially: upserts of ``new_rows``,
    deletes of ``del_ids`` and re-upserts of ``re_ids`` in batches of
    DURABLE_BATCH (a delete batch after every third upsert batch, the
    re-upserts last) → (the upserts' ids in order, each call's wall
    seconds)."""
    b = DURABLE_BATCH
    got, walls = [], []
    dels = iter(range(0, len(del_ids), b))
    for j in range(0, len(new_rows), b):
        t0 = time.perf_counter()
        got.append(m.upsert(new_rows[j:j + b]))
        walls.append(time.perf_counter() - t0)
        if (j // b) % 3 == 2:
            s = next(dels, None)
            if s is not None:
                t0 = time.perf_counter()
                m.delete(del_ids[s:s + b])
                walls.append(time.perf_counter() - t0)
    for s in dels:
        t0 = time.perf_counter()
        m.delete(del_ids[s:s + b])
        walls.append(time.perf_counter() - t0)
    for s in range(0, len(re_ids), b):
        t0 = time.perf_counter()
        m.upsert(re_rows[s:s + b], ids=re_ids[s:s + b])
        walls.append(time.perf_counter() - t0)
    return np.concatenate(got), walls


@contextlib.contextmanager
def timed_fsyncs(wal):
    """Time each ``flush`` + ``fsync`` of ``wal`` (one a mutation batch)
    into the yielded list."""
    walls = []
    real = wal._flush

    def flush():
        t0 = time.perf_counter()
        real()
        walls.append(time.perf_counter() - t0)

    wal._flush = flush
    try:
        yield walls
    finally:
        wal._flush = real


def run_mutate_durable(index, x, q, seed: int):
    """Phase 3 ``mutate_durable`` on the main IVF-Flat index: a
    ``MutableIndex`` with a WAL (fsync, no checkpoint) takes serve_mutate's
    writes in batches of DURABLE_BATCH (the fsync's and each call's wall
    seconds, p50/p99); the object is dropped, ``MutableIndex.recover``
    replays the log onto the base index (seconds, records); fails unless
    the recovered ids on the 256 queries are the live ones, every upserted
    row is its own rank-0 hit and no deleted id comes back. Then the
    checkpoint mode on a 1M-row cut: one fold promotes the checkpoint and
    rewrites the log (a meta record first, sequence numbers still rising),
    and ``recover`` from the checkpoint and the log gives the live ids
    (checkpoint seconds and bytes)."""
    import shutil
    from raft_tpu_torch import mutate, obs, ops
    from raft_tpu_torch.mutate import wal as wal_mod
    from raft_tpu_torch.neighbors import ivf_flat
    n, dev = x.shape[0], x.device
    params = ivf_flat.SearchParams(n_probes=N_PROBES)
    gen = np.random.default_rng(seed + 201)
    picked = gen.choice(n, MUTATE_DELETES + MUTATE_REUPSERTS, replace=False)
    re_ids = picked[:MUTATE_REUPSERTS].astype(np.int32)
    del_ids = picked[MUTATE_REUPSERTS:].astype(np.int64)
    new_rows = mixture_rows(n, MUTATE_UPSERTS, seed, seed + 202, dev)
    re_rows = mixture_rows(n, MUTATE_REUPSERTS, seed, seed + 203, dev)
    new_np, re_np = new_rows.cpu().numpy(), re_rows.cpu().numpy()
    out = os.path.join(OUT_DIR, "durable")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    wal_p = os.path.join(out, "m.wal")
    ops.reset_launch_counts()
    try:
        m = mutate.MutableIndex(index, k=K, params=params)
        wal = wal_mod.MutationWAL(wal_p, sync=True)
        m.attach_wal(wal)
        t0 = time.perf_counter()
        with timed_fsyncs(wal) as fsyncs:
            up_ids, walls = durable_writes(m, new_np, del_ids, re_ids, re_np)
        write_s = time.perf_counter() - t0
        live = search_all(m, q)
        stats = m.stats()
        wal_bytes = os.path.getsize(wal_p)
        del m, wal          # the process "dies": nothing is closed
        gc.collect()
        before = obs.snapshot()
        t0 = time.perf_counter()
        m2 = mutate.MutableIndex.recover(wal_p, k=K, base_index=index,
                                         params=params)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        records = counter_deltas(before, obs.snapshot(), "raft.mutate.wal.")
        if m2.stats() != stats:
            fail(f"mutate_durable: recovered {m2.stats()}, live {stats}")
        back = search_all(m2, q)
        if not np.array_equal(back, live):
            fail(f"mutate_durable: recovered ids differ from the live ones "
                 f"on {int((back != live).sum())} entries")
        self_new = search_all(m2, new_rows)[:, 0] == up_ids
        self_re = search_all(m2, re_rows)[:, 0] == re_ids
        self_hit = float(np.concatenate([self_new, self_re]).mean())
        if self_hit < 1.0:
            fail(f"mutate_durable: upserted rows find themselves at rank 0 "
                 f"on {self_hit:.6f} after recovery")
        dead = search_all(m2, x[torch.from_numpy(del_ids).to(dev)])
        if np.isin(dead, del_ids).any():
            fail("mutate_durable: a deleted id came back after recovery")
        del m2
        launches_log = ops.launch_counts()

        # the checkpoint mode on the 1M-row cut
        rows = min(n, DURABLE_CKPT_ROWS)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        small = ivf_flat.build(x[:rows], ivf_flat.IndexParams(
            n_lists=N_LISTS, kmeans_n_iters=KMEANS_ITERS))
        torch.cuda.synchronize()
        small_build_s = time.perf_counter() - t0
        ckpt_p, wal2_p = os.path.join(out, "m.ckpt"), os.path.join(out,
                                                                   "c.wal")
        m3 = mutate.MutableIndex(small, k=K, params=params)
        m3.attach_wal(wal_mod.MutationWAL(wal2_p, sync=True),
                      checkpoint_path=ckpt_p)
        m3.upsert(new_np[:DURABLE_CKPT_UPSERTS])
        m3.delete(np.arange(0, rows, rows // 512)[:512])
        last_seq = wal_mod.MutationWAL(wal2_p, sync=False).replay()[-1].seq
        with timed_parts([(mutate.MutableIndex, "_checkpoint_epoch",
                           "checkpoint"),
                          (mutate.MutableIndex, "_swap_epoch", "swap")]
                         ) as (parts, _):
            t0 = time.perf_counter()
            if not m3.compact():
                fail("mutate_durable: the fold did not run")
            fold_s = time.perf_counter() - t0
        recs = wal_mod.MutationWAL(wal2_p, sync=False).replay()
        if not recs or recs[0].op != wal_mod.OP_META or \
                recs[0].seq <= last_seq or \
                any(b.seq != a.seq + 1 for a, b in zip(recs, recs[1:])):
            fail(f"mutate_durable: the log was not rewritten to a meta "
                 f"record at a rising sequence number: "
                 f"{[(r.op, r.seq) for r in recs][:4]} after {last_seq}")
        ckpt_bytes = os.path.getsize(ckpt_p)
        m3.upsert(re_np[:DURABLE_BATCH])
        m3.delete([1, 2, 3])
        live3 = search_all(m3, q)
        stats3 = m3.stats()
        del m3
        gc.collect()
        t0 = time.perf_counter()
        m4 = mutate.MutableIndex.recover(wal2_p, k=K,
                                         checkpoint_path=ckpt_p,
                                         params=params)
        torch.cuda.synchronize()
        ckpt_replay_s = time.perf_counter() - t0
        if m4.index.device != dev or m4.stats() != stats3:
            fail(f"mutate_durable: checkpoint recovery gave {m4.stats()} "
                 f"on {m4.index.device}, live {stats3}")
        if not np.array_equal(search_all(m4, q), live3):
            fail("mutate_durable: ids after checkpoint recovery differ "
                 "from the live ones")
        del m4, small
        launches_ckpt = ops.launch_counts()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    check_launched("mutate_durable", launches_log, ("select_k",
                                                    "ivf_scan"))
    check_launched("mutate_durable (checkpoint)", launches_ckpt,
                   ("fused_l2_nn", "select_k", "ivf_scan"))
    pct = lambda a: [float(v) * 1e3 for v in  # noqa: E731
                     np.percentile(a, [50, 99])]
    phase("mutate_durable", n=n, upserts=MUTATE_UPSERTS,
          deletes=MUTATE_DELETES, reupserts=MUTATE_REUPSERTS,
          batch=DURABLE_BATCH, batches=len(walls), write_s=write_s,
          fsync_ms_p50_p99=pct(fsyncs), fsyncs=len(fsyncs),
          call_ms_p50_p99=pct(walls), wal_mb=wal_bytes / 1e6,
          replay_s=replay_s, wal_counters=records,
          records_replayed=records.get("raft.mutate.wal.replayed.total", 0),
          stats=stats, ids_equal_live=True, self_hit_rank0=self_hit,
          deleted_returned=0, launches=launches_log,
          ckpt_cut={"rows": rows, "note": "the checkpoint mode runs on the "
                    "first rows: a checkpoint writes the whole folded "
                    "index to local disk"},
          ckpt_build_s=small_build_s, fold_s=fold_s,
          checkpoint_s=parts["checkpoint"], swap_s=parts["swap"],
          checkpoint_gb=ckpt_bytes / 1e9, ckpt_log_records=len(recs),
          ckpt_recover_s=ckpt_replay_s, ckpt_ids_equal_live=True,
          ckpt_launches=launches_ckpt)
    free_phase("mutate_durable")


def router_burst(router, q_np):
    """The burst's 512 single-query requests from 128 threads through a
    fleet router → (ids, latencies, wall seconds, errors); nothing fails
    here, so a thread may run it."""
    ids = [None] * N_REQUESTS

    def call(r):
        ids[r] = router.search(q_np[r % len(q_np)], timeout=600)[1][0]

    lat, wall, errors = closed_loop(call, N_THREADS)
    return ids, lat, wall, errors


def rows_per_batch(batch: dict):
    """Mean rows a batch from ``raft.serve.batch.*`` counter deltas, or
    None when no batch ran in this process."""
    n = sum(v for k_, v in batch.items()
            if k_.startswith("raft.serve.batch.total"))
    return batch.get("raft.serve.batch.rows", 0) / n if n else None


def launch_delta(before: dict, after: dict) -> dict:
    """Kernel launches between two reads of ``{source: launch counts}``,
    summed over the sources in both reads (a daemon killed or respawned
    in between drops out); kernels that did not launch are left out."""
    out = {}
    for src, now in after.items():
        then = before.get(src)
        if then is None:
            continue
        for k_, v in now.items():
            out[k_] = out.get(k_, 0) + v - then.get(k_, 0)
    return {k_: v for k_, v in out.items() if v}


def stall_bound_ms(rounds: list, own_p99_ms: float, rpc_s: float) -> float:
    """The slowest request a round with an action in it may have:
    FLEET_STALL_X times the larger of its own p99 and the last quiet
    round's, plus ``rpc_s`` (for remote replicas the RPC timeout and a
    load probe: what a request to a SIGKILLed daemon waits before it is
    retried elsewhere)."""
    quiet = [r["p99_ms"] for r in rounds if not r["action"]]
    ref = max(own_p99_ms, quiet[-1] if quiet else 0.0)
    return FLEET_STALL_X * ref + rpc_s * 1e3


def fleet_round(router, q_np, name: str, rounds: list, action=None,
                delay_s: float = 0.1, counts=None, rpc_s: float = 0.0):
    """One burst through ``router``, with ``action()`` run on a thread
    ``delay_s`` into it → the action's result. ``counts()`` (``{source:
    launch counts}``) is read just before and just after the burst: the
    round's kernel launches. Fails on any failed request, a failed
    action, or, in a round with an action, a request slower than
    :func:`stall_bound_ms`; the round's QPS, p50, p99, slowest request
    and launches go to ``rounds``."""
    from raft_tpu_torch import obs
    box = {}
    th = None
    before = obs.snapshot()
    counts_before = counts() if counts is not None else None
    if action is not None:
        def run():
            time.sleep(delay_s)
            try:
                box["out"] = action()
            except Exception as e:  # reported after the join
                box["err"] = repr(e)
        th = threading.Thread(target=run, daemon=True)
        th.start()
    ids, lat, wall, errors = router_burst(router, q_np)
    counts_after = counts() if counts is not None else None
    if th is not None:
        th.join(timeout=600)
    # the router's own account of the round: routes, retries, suspects,
    # failed load probes, by replica
    moves = {k_.replace("raft.fleet.", ""): v for k_, v in
             counter_deltas(before, obs.snapshot(), "raft.fleet.").items()
             if v and not k_.startswith("raft.fleet.proc.")}
    if errors:
        fail(f"{name}: {len(errors)} requests failed, first {errors[0]}, "
             f"distinct {sorted(set(errors))[:4]}; the router's counters "
             f"over the round: {moves}")
    if "err" in box or (th is not None and th.is_alive()):
        fail(f"{name}: the action failed: {box.get('err', 'still running')}")
    row = dict(round=name, action=action is not None,
               **latency_row(lat, wall), max_ms=float(lat.max()) * 1e3,
               fleet=moves)
    if action is not None:
        row["bound_ms"] = stall_bound_ms(rounds, row["p99_ms"], rpc_s)
        if row["max_ms"] > row["bound_ms"]:
            fail(f"{name}: the slowest request took {row['max_ms']:.1f} "
                 f"ms, over the round's bound of {row['bound_ms']:.1f}")
    if counts is not None:
        row["launches"] = launch_delta(counts_before, counts_after)
    # the batches this process's servers ran (none for remote replicas)
    per = rows_per_batch(counter_deltas(before, obs.snapshot(),
                                        "raft.serve.batch."))
    if per is not None:
        row["rows_per_batch"] = per
    rounds.append(row)
    return box.get("out")


def run_serve_fleet(index, q, q_np, main: dict, seed: int):
    """Phase 3 ``serve_fleet``: three replicas in this process over the
    main index (module docstring). The primary's ``MutableIndex`` logs to
    a WAL under ``chiprun_out/fleet`` (removed after the phase)."""
    import shutil
    from raft_tpu_torch import fleet, obs, ops
    from raft_tpu_torch.mutate import MutableIndex
    from raft_tpu_torch.mutate.wal import MutationWAL
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    t_phase = time.perf_counter()
    n, dev = index.size, index.device
    params = ivf_flat.SearchParams(n_probes=N_PROBES)
    cfg = ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                      max_wait_ms=2.0)
    gen = np.random.default_rng(seed + 301)
    picked = gen.choice(n, MUTATE_DELETES + MUTATE_REUPSERTS, replace=False)
    re_ids = picked[:MUTATE_REUPSERTS].astype(np.int32)
    del_ids = picked[MUTATE_REUPSERTS:].astype(np.int64)
    new_np = mixture_rows(n, MUTATE_UPSERTS, seed, seed + 302,
                          dev).cpu().numpy()
    re_np = mixture_rows(n, MUTATE_REUPSERTS, seed, seed + 303,
                         dev).cpu().numpy()
    out = os.path.join(OUT_DIR, "fleet")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    wal_p = os.path.join(out, "primary.wal")
    prim = MutableIndex(index, k=K, params=params)
    wal = MutationWAL(wal_p, sync=True)
    prim.attach_wal(wal)
    followers, boot_s, ladder_s = {}, [], []

    def serve(m):
        t0 = time.perf_counter()
        srv = SearchServer.from_index(m, q_np[:128], K, config=cfg)
        ladder_s.append(time.perf_counter() - t0)
        return srv

    def restart(rep):
        """A replica's (re)birth: the primary's server anew over its own
        index; a follower bootstrapped from the whole log."""
        if rep.name == "r0":
            rep.set_server(serve(prim))
            return
        t0 = time.perf_counter()
        m, reader, applier = fleet.bootstrap_replica(
            wal_p, K, base_index=index, params=params, name=rep.name,
            device=dev)
        boot_s.append(time.perf_counter() - t0)
        repl = fleet.Replicator(m, wal_p, name=rep.name, poll_ms=5.0,
                                reader=reader, applier=applier)
        followers[rep.name] = (m, repl)
        rep.set_server(serve(m), replicator=repl)

    def caught_up(what: str) -> None:
        for name, (_, repl) in followers.items():
            if not repl.drain(FLEET_CATCHUP_S) or repl.gap:
                fail(f"serve_fleet: follower {name} did not catch up "
                     f"{what}")

    def parity(what: str) -> None:
        caught_up(what)
        want = search_all(prim, q)
        for name, (m, _) in followers.items():
            got = search_all(m, q)
            if not np.array_equal(got, want):
                fail(f"serve_fleet: follower {name}'s ids differ from the "
                     f"primary's on {int((got != want).sum())} entries "
                     f"{what}")

    reps = [fleet.Replica(f"r{i}") for i in range(FLEET_REPLICAS)]
    for rep in reps:
        restart(rep)
        rep.mark_serving()
    first_boot = list(boot_s)
    router = fleet.FleetRouter(reps, fleet.FleetConfig(
        max_retries=FLEET_MAX_RETRIES, seed=seed))
    rounds, lag = [], {name: 0 for name in followers}
    ep = None

    def counts():
        return {"self": ops.launch_counts()}

    try:
        ops.reset_launch_counts()
        before = obs.snapshot()
        # 1. the burst while the primary takes serve_mutate's writes
        errors, got = [], []
        writer = threading.Thread(target=lambda: got.extend(mutate_writer(
            prim, new_np, del_ids, re_ids, re_np, errors)), daemon=True)
        stop_lag = threading.Event()

        def sample_lag():
            while not stop_lag.is_set():
                tip = wal.next_seq - 1
                for name, (_, repl) in list(followers.items()):
                    lag[name] = max(lag[name],
                                    tip - repl.applier.applied_seq)
                time.sleep(0.005)

        sampler = threading.Thread(target=sample_lag, daemon=True)
        writer.start()
        sampler.start()
        while True:
            fleet_round(router, q_np, "writes", rounds, counts=counts)
            if not writer.is_alive():
                break
        writer.join(timeout=60)
        if errors:
            fail(f"serve_fleet: the writer failed: {errors[:1]}")
        caught_up("after the writes")
        stop_lag.set()
        sampler.join(timeout=10)
        lag_s = {k_: v for k_, v in obs.snapshot()["gauges"].items()
                 if k_.startswith("raft.fleet.replication.lag_seconds")}
        parity("after the writes")
        # 2. a follower killed mid-burst, then brought back
        victim = reps[-1]
        fleet_round(router, q_np, "kill", rounds, action=victim.kill,
                    counts=counts)
        # the routed traffic's own launches (the bursts alone; the parity
        # searches and the servers' ladder warm-ups launch kernels too)
        burst_launches = {}
        for r in rounds:
            for k_, v in r["launches"].items():
                burst_launches[k_] = burst_launches.get(k_, 0) + v
        check_launched("serve_fleet's routed bursts", burst_launches,
                       ("select_k", "select_k_payload", "ivf_scan"))
        victim.begin_bootstrap()
        restart(victim)
        victim.mark_serving()
        parity("after the kill")
        # 3. a rolling restart of every replica under load
        stop = threading.Event()
        traffic = []

        def loop():
            while not stop.is_set():
                traffic.append(router_burst(router, q_np))

        th = threading.Thread(target=loop, daemon=True)
        b0 = obs.snapshot()
        th.start()
        t0 = time.perf_counter()
        report = fleet.rolling_restart(router, restart,
                                       drain_timeout_s=60.0)
        rolling_s = time.perf_counter() - t0
        stop.set()
        th.join(timeout=600)
        rolling_batches = rows_per_batch(counter_deltas(
            b0, obs.snapshot(), "raft.serve.batch."))
        if not report["ok"]:
            fail(f"serve_fleet: the rolling restart failed: {report}")
        for i, (_, lat, wall, errs) in enumerate(traffic):
            if errs:
                fail(f"serve_fleet: {len(errs)} requests failed during "
                     f"the rolling restart, first {errs[0]}")
            row = dict(round=f"rolling{i}", action=True,
                       **latency_row(lat, wall),
                       max_ms=float(lat.max()) * 1e3)
            row["bound_ms"] = stall_bound_ms(rounds, row["p99_ms"], 0.0)
            if row["max_ms"] > row["bound_ms"]:
                fail(f"serve_fleet: rolling{i}'s slowest request took "
                     f"{row['max_ms']:.1f} ms, over the round's bound of "
                     f"{row['bound_ms']:.1f}")
            rounds.append(row)
        parity("after the rolling restart")
        launches = ops.launch_counts()
        deltas = counter_deltas(before, obs.snapshot(), "raft.fleet.")
        # the surfaces: the router's report and /healthz's fleet section
        time.sleep(fleet.FleetRouter._GAUGE_REFRESH_S + 0.05)
        router.search(q_np[:1], timeout=600)
        body = router.report()
        ep = obs.serve(port=0, fleet=router)
        _, health = http_call(ep.port, "GET", "/healthz")
        code, dbg = http_call(ep.port, "GET", "/debug/fleet")
        hf = health.get("fleet", {})
        if body["serving"] != FLEET_REPLICAS or \
                len(body["replicas"]) != FLEET_REPLICAS or code != 200 or \
                dbg["serving"] != FLEET_REPLICAS or \
                (hf.get("replicas"), hf.get("serving")) != \
                (FLEET_REPLICAS, FLEET_REPLICAS):
            fail(f"serve_fleet: the fleet's surfaces do not count "
                 f"{FLEET_REPLICAS} replicas serving: report "
                 f"{body['serving']}, /healthz {hf}")
    finally:
        if ep is not None:
            ep.close()
        router.close()
        shutil.rmtree(out, ignore_errors=True)
    phase("serve_fleet", n=n, replicas=FLEET_REPLICAS,
          max_retries=FLEET_MAX_RETRIES, upserts=MUTATE_UPSERTS,
          deletes=MUTATE_DELETES, reupserts=MUTATE_REUPSERTS,
          rounds=rounds, failed_requests=0,
          main_burst={k_: main[k_] for k_ in ("qps", "p50_ms", "p99_ms")},
          main_rows_per_batch=rows_per_batch(main.get("batches", {})),
          rolling_rows_per_batch=rolling_batches, lag_records_max=lag,
          lag_seconds_last=lag_s,
          bootstrap_s_first=first_boot, bootstrap_s_restart=boot_s[
              len(first_boot):], ladder_s=ladder_s, rolling_s=rolling_s,
          rolling=report["replicas"], routed={
              k_: v for k_, v in deltas.items()
              if k_.startswith("raft.fleet.route.total")},
          retries=deltas.get("raft.fleet.retry.total", 0),
          suspects=deltas.get("raft.fleet.suspect.total", 0),
          healthz_fleet=hf, ids_equal_primary=True,
          burst_launches=burst_launches,
          phase_launches={k_: v for k_, v in launches.items() if v},
          seconds=time.perf_counter() - t_phase)
    del prim, followers, reps, router
    free_phase("serve_fleet")


def daemon_log(fp) -> str:
    with open(os.path.join(fp.workdir, "daemon.log")) as f:
        return f.read()


def daemon_counts(pf) -> dict:
    """``{"name:pid": launch counts}`` of the fleet's daemons that answer
    ``/rpc/state`` (one SIGKILLed may not, or only after a timeout)."""
    from raft_tpu_torch.serve import DispatchError
    out = {}
    for fp in pf.processes():
        if not fp.alive():
            continue
        try:
            st = fp.client.state(timeout=PROC_PROBE_S)
        except DispatchError:
            continue
        out[f"{fp.name}:{st['pid']}"] = st["launches"]
    return out


def remote_ids(client, q_np) -> np.ndarray:
    """The 256 queries through one daemon's ``/rpc/search`` in 128-row
    requests → ids."""
    out = []
    for s in range(0, q_np.shape[0], 128):
        status, body = client.search_raw(q_np[s:s + 128], k=K,
                                         deadline_ms=600_000.0)
        if status != 200:
            fail(f"fleet_procs: /rpc/search answered {status}: {body}")
        out.append(np.asarray(body["ids"]))
    return np.concatenate(out)


def compile_events(url: str) -> dict:
    """A daemon's ``raft.compile_cache.event`` counters from its
    ``/metrics``: kernel libraries found built (hits) or built (misses)."""
    import urllib.request
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    got = {"cache_hits": 0.0, "cache_misses": 0.0}
    for line in text.splitlines():
        if line.startswith("raft_compile_cache_event"):
            for ev in got:
                if f'event="{ev}"' in line:
                    got[ev] += float(line.rsplit(" ", 1)[1])
    return got


def run_fleet_procs(q_np, seed: int):
    """Phase 3 ``fleet_procs``: three ``fleetd`` daemons on this card
    (module docstring). Their files live under ``chiprun_out/fleet_procs``;
    the daemons' logs stay, their logs of mutations and checkpoints are
    removed after the phase."""
    import re
    import shutil
    from raft_tpu_torch import fleet
    t_phase = time.perf_counter()
    phase("cut", n=PROC_N, note="fleet_procs: each daemon builds its own "
          "copy at this cut of the 10,000,000 rows; three share the card "
          "beside the 10M index")
    card = torch.cuda.get_device_name(0)
    out = os.path.join(OUT_DIR, "fleet_procs")
    shutil.rmtree(out, ignore_errors=True)
    rng = np.random.default_rng(seed + 401)
    free0 = torch.cuda.mem_get_info()[0]
    rounds, parts, pf, router = [], {}, None, None

    def replica(fp):
        return fleet.RemoteReplica(fp.name, fp.url, pool_workers=PROC_POOL,
                                   timeout_s=PROC_RPC_TIMEOUT_S)

    def counts():
        return daemon_counts(pf)

    def burst(name, action=None):
        return fleet_round(router, q_np, name, rounds, action=action,
                           counts=counts,
                           rpc_s=PROC_RPC_TIMEOUT_S + PROC_PROBE_S)

    def swap_in(fp):
        router.remove_replica(fp.name).kill()
        router.add_replica(replica(fp))

    def write(client, batches: int) -> int:
        n_up = 0
        for j in range(batches):
            rows = (rng.normal(size=(PROC_BATCH, D)) * 5.0).astype(np.float32)
            n_up += len(client.upsert(rows, timeout=600))
            if j % 2:
                client.delete(rng.choice(PROC_N, PROC_BATCH, replace=False),
                              timeout=600)
        return n_up

    def caught_up(primary, names, what):
        tip = int(primary.client.state()["wal_next_seq"]) - 1
        deadline = time.monotonic() + FLEET_CATCHUP_S
        for name in names:
            while int(pf.process(name).client.state().get(
                    "applied_seq", -1)) < tip:
                if time.monotonic() > deadline:
                    fail(f"fleet_procs: {name} did not catch up {what}")
                time.sleep(0.05)

    def parity(primary, what):
        others = [fp.name for fp in pf.processes() if fp.name != primary.name]
        caught_up(primary, others, what)
        want = remote_ids(primary.client, q_np)
        for name in others:
            got = remote_ids(pf.process(name).client, q_np)
            if not np.array_equal(got, want):
                fail(f"fleet_procs: {name}'s ids differ from "
                     f"{primary.name}'s on {int((got != want).sum())} "
                     f"entries {what}")

    try:
        t0 = time.perf_counter()
        pf = fleet.ProcessFleet(
            out, n_procs=PROC_REPLICAS, n=PROC_N, dim=D, seed=seed,
            n_lists=N_LISTS, k=K, n_probes=N_PROBES, deadline_ms=600_000.0,
            batch_sizes=",".join(str(b) for b in BATCH_SIZES),
            platform="cuda", startup_timeout_s=PROC_STARTUP_S,
            extra_args=["--max-queue", "512", "--max-wait-ms", "2.0"])
        parts["spawn_s"] = time.perf_counter() - t0
        used_up = (free0 - torch.cuda.mem_get_info()[0]) / 1e9
        for fp in pf.processes():
            m = re.search(r"device cuda: (.+)", daemon_log(fp))
            if m is None or m.group(1).strip() != card:
                fail(f"fleet_procs: {fp.name} did not run on {card!r}: "
                     f"{m.group(1) if m else 'no device line'}")
        c0 = counts()
        base = {fp.name: remote_ids(fp.client, q_np)
                for fp in pf.processes()}
        rpc_128_launches = launch_delta(c0, counts())
        if any(not np.array_equal(v, base["r0"]) for v in base.values()):
            fail("fleet_procs: the daemons' builds at one seed differ")
        check_launched("fleet_procs's 128-row /rpc/search", rpc_128_launches,
                       ("select_k", "select_k_payload", "ivf_scan"))
        router = fleet.FleetRouter([replica(fp) for fp in pf.processes()],
                                   fleet.FleetConfig(
                                       max_retries=FLEET_MAX_RETRIES,
                                       seed=seed))
        burst("steady")
        # writes to the primary over HTTP while the followers tail it
        n_up = burst("writes", lambda: write(pf.primary().client,
                                             PROC_UPSERT_BATCHES))
        parity(pf.process("r0"), "after the writes")
        # a follower SIGKILLed mid-burst, then respawned
        burst("sigkill", lambda: pf.kill("r2"))
        t0 = time.perf_counter()
        swap_in(pf.respawn("r2"))
        parts["respawn_follower_s"] = time.perf_counter() - t0
        parity(pf.process("r0"), "after the respawn")
        # the primary SIGKILLed and a follower promoted mid-burst

        def failover():
            pf.kill("r0")
            t = time.perf_counter()
            res = pf.promote("r1")
            parts["promote_s"] = time.perf_counter() - t
            return res

        promoted = burst("failover", failover)
        new = pf.process("r1")
        n_up += write(new.client, 2)
        # the old primary back as a follower: the new primary's checkpoint
        # over /rpc/checkpoint, then its log
        t0 = time.perf_counter()
        old = pf.respawn("r0", role="follower")
        parts["respawn_from_checkpoint_s"] = time.perf_counter() - t0
        swap_in(old)
        ckpt = os.path.join(old.workdir, "r0.ckpt.npz")
        if not os.path.exists(ckpt):
            fail("fleet_procs: the respawned r0 fetched no checkpoint")
        parts["checkpoint_gb"] = os.path.getsize(ckpt) / 1e9
        parity(new, "after the promotion")
        burst("after")
        # the routed traffic's own launches, in the rounds whose daemons
        # built nothing meanwhile (the failover's promotion folds and
        # warms a new epoch); one RPC worker a request, so a daemon's
        # batches hold at most PROC_POOL rows and take the probe-major
        # plan: kernel 2 on each, kernel 3 on none
        routed_launches = {}
        for r in rounds:
            if r["round"] != "failover":
                for k_, v in r["launches"].items():
                    routed_launches[k_] = routed_launches.get(k_, 0) + v
        check_launched("fleet_procs's routed bursts", routed_launches,
                       ("select_k", "select_k_payload"))
        events = {fp.name: compile_events(fp.url) for fp in pf.processes()}
        if any(e["cache_misses"] or not e["cache_hits"]
               for e in events.values()):
            fail(f"fleet_procs: a daemon compiled a kernel: {events}")
        used_peak = (free0 - torch.cuda.mem_get_info()[0]) / 1e9
        body = router.report()
    finally:
        if router is not None:
            router.close()
        if pf is not None:
            pf.close()
    if any(fp.alive() for fp in pf.processes()):
        fail("fleet_procs: a daemon outlived the fleet's close")
    launches = {}
    for fp in pf.processes():
        m = re.findall(r"kernel launches: (\{.*\})", daemon_log(fp))
        if not m:
            fail(f"fleet_procs: {fp.name} did not exit clean")
        launches[fp.name] = {k_: v for k_, v in json.loads(m[-1]).items()
                             if v}
        if not launches[fp.name].get("select_k") or \
                not launches[fp.name].get("ivf_scan"):
            fail(f"fleet_procs: {fp.name} never launched kernels 2 and 3")
    for root, _, files in os.walk(out):
        for f_ in files:
            if not f_.endswith(".log"):
                os.remove(os.path.join(root, f_))
    phase("fleet_procs", n=PROC_N, dim=D, n_lists=N_LISTS, k=K,
          n_probes=N_PROBES, replicas=PROC_REPLICAS, card=card,
          rounds=rounds, failed_requests=0, upserts=n_up,
          promoted=promoted.get("primary") if promoted else None,
          next_seq=promoted.get("next_seq") if promoted else None,
          **parts, card_used_gb_daemons_up=used_up,
          card_used_gb_peak=used_peak,
          card_used_gb_after_close=(free0 - torch.cuda.mem_get_info()[0])
          / 1e9, compile_events=events, routed_launches=routed_launches,
          rpc_128_launches=rpc_128_launches, daemon_life_launches=launches,
          serving=body["serving"], ids_equal=True,
          seconds=time.perf_counter() - t_phase)


class PostmortemSpy:
    """What ``fleet_postmortem`` reads inside loadgen's own run: its
    ``run_open_loop`` wrapped (launch counts just before and after, each
    request's latency and, in a daemon run, the checks made while the
    killed daemon is still down: loadgen respawns it once the loop ends)
    and, in a daemon run, ``ProcessFleet`` subclassed (the instance, each
    SIGKILL's wall time, and the daemons' batch shapes, which loadgen has
    no argument for). Checks that fail are collected and failed after
    loadgen has closed its fleet; ``__exit__`` fails the phase when a
    hook was never reached."""

    def __init__(self, q_np, procs: bool):
        self.q_np, self.procs = q_np, procs
        self.pf = None
        self.t_kill = {}
        self.lat = []
        self.launches = None
        self.checks = {}
        self.errors = []

    def counts(self):
        from raft_tpu_torch import ops
        if self.pf is None:
            return {"local": dict(ops.launch_counts())}
        return daemon_counts(self.pf)

    def __enter__(self):
        from raft_tpu_torch import fleet
        from raft_tpu_torch.tools import loadgen
        spy = self
        self._saved = (loadgen.run_open_loop, fleet.ProcessFleet)
        run, pf_cls = self._saved

        class SpyFleet(pf_cls):
            def __init__(self, *a, **kw):
                spy.pf = self
                kw["batch_sizes"] = ",".join(str(b) for b in BATCH_SIZES)
                super().__init__(*a, **kw)

            def kill(self, name):
                spy.t_kill[name] = time.time()
                return super().kill(name)

        def spy_run(server, *a, **kw):
            before = spy.counts()
            out = run(_Timed(server, spy.lat), *a, **kw)
            spy.launches = launch_delta(before, spy.counts())
            if spy.procs:
                try:
                    spy.after_daemon_load(server)
                except Exception as e:  # failed after the fleet's close
                    spy.errors.append(f"post-load checks raised {e!r}")
            return out

        loadgen.run_open_loop = spy_run
        if self.procs:
            fleet.ProcessFleet = SpyFleet
        return self

    def __exit__(self, *exc):
        from raft_tpu_torch import fleet
        from raft_tpu_torch.tools import loadgen
        loadgen.run_open_loop, fleet.ProcessFleet = self._saved
        if self.pf is not None:
            self.pf.close()
        if exc[0] is None and (self.launches is None
                               or (self.procs and self.pf is None)):
            fail("fleet_postmortem: loadgen never reached a hook "
                 f"(open loop {self.launches is not None}, "
                 f"ProcessFleet {self.pf is not None})")

    def after_daemon_load(self, router):
        """The daemon run's checks after its open loop, the killed daemon
        still down. The fleet endpoints are this phase's own aggregator,
        a second ``MetricsFederator`` over the same daemons (loadgen's
        keeps running; its report carries the federation section)."""
        from raft_tpu_torch import obs
        from raft_tpu_torch.obs import federation
        from raft_tpu_torch.tools import doctor
        c = self.checks
        fed = federation.MetricsFederator(self.pf.urls(), fleet=router)
        agg = obs.serve(federator=fed, fleet=router)
        try:
            fed.scrape_once()
            self._fleet_checks(router, fed, agg.port)
        finally:
            agg.close()
            fed.close()
        # the dead daemon's own dump, before its respawn reopens the dir
        dump = os.path.join(self.pf.process("r1").workdir, "blackbox")
        diag = doctor.diagnose_dump(dump)
        newest = max((r.get("t_unix") or 0.0)
                     for r in doctor.load_dump(dump)) if diag["records"] \
            else None
        lag = self.t_kill["r1"] - newest if newest is not None else None
        c["killed_dump"] = {
            "records": diag["records"], "verdict": diag["verdict"],
            "evidence": diag["evidence"],
            "last_flush_reason": diag.get("last_flush_reason"),
            "newest_record_before_kill_s": lag,
            "boxes": box_stats(dump)}
        if not diag["records"] or lag is None or not -0.5 <= lag <= \
                PM_NEWEST_S:
            self.errors.append(f"the SIGKILLed daemon's dump: "
                               f"{c['killed_dump']}")
        out = os.path.join(OUT_DIR, "fleet_postmortem")
        with open(os.path.join(out, "procs_r1_diagnosis.json"), "w") as f:
            json.dump(diag, f, indent=1, default=str)
        import shutil
        shutil.copytree(dump, os.path.join(out, "procs_r1_blackbox"))
        # the 128-row requests on every survivor: kernel 3
        c0 = daemon_counts(self.pf)
        for fp in self.pf.processes():
            if fp.alive():
                remote_ids(fp.client, self.q_np)
        c["rpc_128_launches"] = launch_delta(c0, daemon_counts(self.pf))
        if not c["rpc_128_launches"].get("ivf_scan"):
            self.errors.append(f"the 128-row /rpc/search requests launched "
                               f"no kernel 3: {c['rpc_128_launches']}")

    def _fleet_checks(self, router, fed, port: int):
        """``/fleet/healthz`` while r1 is down, the completed rollup
        against the live daemons' own ``/metrics``, and one routed
        request's ``/fleet/trace``."""
        from raft_tpu_torch import obs
        from raft_tpu_torch.obs import spans
        c = self.checks
        code, hz = http_call(port, "GET", "/fleet/healthz")
        c["fleet_healthz_while_down"] = {
            "code": code, "status": hz["status"], "stale": hz["stale"],
            "r1": hz["instances"].get("r1")}
        if code != 503 or not ("r1" in hz["stale"] or hz["instances"].get(
                "r1", {}).get("status") in ("stale", "unreachable")):
            self.errors.append(f"/fleet/healthz while r1 is down: {code} "
                               f"{c['fleet_healthz_while_down']}")
        name = "raft_serve_completed_total_total"
        _, text = http_call(port, "GET", "/fleet/metrics")
        rollup = rollup_value(text, name)
        own = {}
        for n in fed.live_instances():
            p = int(fed.url_instances()[n].rsplit(":", 1)[1])
            sums = parse_prometheus(http_call(p, "GET", "/metrics")[1])
            own[n] = sums.get(name, 0.0)
            c.setdefault("blackbox_counters", {})[n] = {
                k_: sums.get(f"raft_obs_blackbox_{k_}_total_total")
                for k_ in ("flushes", "bytes")}
        c["completed_rollup"] = {"fleet": rollup, "own": own}
        if rollup is None or rollup != sum(own.values()):
            self.errors.append(f"the completed rollup {rollup} is not the "
                               f"live daemons' sum {own}")
        c["federation_rows"] = {
            n: {k_: row.get(k_) for k_ in ("state", "scrapes", "errors")}
            for n, row in fed.report()["instances"].items()}
        prev = (spans.trace_enabled(), spans.trace_sample_rate())
        spans.set_trace_enabled(True)
        spans.set_trace_sample_rate(1.0)
        try:
            router.search(self.q_np[:1], timeout=60)
        finally:
            spans.set_trace_enabled(prev[0])
            spans.set_trace_sample_rate(prev[1])
        # the newest route root: the last attempt's (a retry roots its
        # own trace)
        tid = next(t["trace_id"] for t in obs.RECORDER.requests()
                   if t.get("name") == "raft.fleet.route")
        code, body = http_call(port, "GET", f"/fleet/trace?trace={tid}")
        insts = sorted({e["args"].get("instance") for e in
                        body.get("traceEvents", ()) if e["ph"] == "X"})
        c["fleet_trace"] = {"code": code, "instances": insts,
                            "other": body.get("otherData", body)}
        if "local" not in insts or not any(i != "local" for i in insts):
            self.errors.append(f"/fleet/trace: {c['fleet_trace']}")


class _Timed:
    """A router proxy whose ``submit`` notes each request's seconds (a
    failure's too) into ``lat``."""

    def __init__(self, inner, lat: list):
        self._inner, self._lat = inner, lat

    def submit(self, *a, **kw):
        t0 = time.perf_counter()
        fut = self._inner.submit(*a, **kw)
        fut.add_done_callback(
            lambda _f: self._lat.append(time.perf_counter() - t0))
        return fut

    def __getattr__(self, name):
        return getattr(self._inner, name)


def rollup_value(text: str, name: str):
    """The unlabelled sample of ``name`` in exposition text (a
    federator's fleet rollup), or None."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


def box_stats(path: str) -> dict:
    """A black box directory's flushes (its meta records) and bytes on
    disk."""
    from raft_tpu_torch.obs import blackbox
    recs = blackbox.read_dump(path)
    return {"flushes": sum(1 for r in recs if r["kind"] == "meta"),
            "bytes": sum(os.path.getsize(f)
                         for f in blackbox._segment_files(path))}


def run_loadgen(argv: list) -> tuple:
    """``loadgen.main(argv)`` in this process → ``(rc, its last JSON
    line)``; its other output goes to stderr."""
    import contextlib
    import io
    from raft_tpu_torch.tools import loadgen
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = loadgen.main(argv)
    lines = buf.getvalue().splitlines()
    sys.stderr.write("\n".join(lines[:-1]) + "\n")
    return rc, json.loads(lines[-1]) if lines else {}


def run_summary(report: dict, lat: list) -> dict:
    """One loadgen run's numbers for the phase line."""
    return dict({k_: report.get(k_) for k_ in (
        "offered", "offered_qps", "achieved_qps", "completed", "errors",
        "shed", "deadline_expired", "p50_ms", "p99_ms")},
        slowest_ms=max(lat) * 1e3 if lat else None,
        retries=report.get("fleet", {}).get("retries"),
        route_share=report.get("fleet", {}).get("route_share"))


def run_fleet_postmortem(q_np):
    """Phase 3 ``fleet_postmortem``: loadgen's in-process fleet and its
    daemon fleet, each with a replica killed, read back by the doctor
    (module docstring). The in-process run's boxes stay under
    ``chiprun_out/fleet_postmortem/inproc`` (r1's only), the killed
    daemon's under ``chiprun_out/fleet_postmortem/procs_r1_blackbox``."""
    import shutil
    from raft_tpu_torch.obs import profiler
    from raft_tpu_torch.tools import doctor
    t_phase = time.perf_counter()
    card = gpu_line()
    out = os.path.join(OUT_DIR, "fleet_postmortem")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    inproc = os.path.join(out, "inproc")
    # (a) in process, at the full 10M rows
    t0 = time.perf_counter()
    with PostmortemSpy(q_np, procs=False) as spy:
        try:
            rc, rep = run_loadgen(PM_COMMON + PM_INPROC
                                  + ["--blackbox", inproc])
        finally:
            profiler.disable_profiling()
    a_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    killed = rep.get("blackbox", {}).get("killed_replica", {})
    if rc != 0 or rep.get("errors") != 0 or not killed.get("dump_readable"):
        fail(f"fleet_postmortem (a): rc {rc}, errors {rep.get('errors')}, "
             f"killed replica {killed}")
    a_launch = spy.launches
    if not a_launch.get("select_k"):
        fail(f"fleet_postmortem (a): kernel 2 not launched in the open "
             f"loop: {a_launch}")
    diag = doctor.diagnose_dump(os.path.join(inproc, "r1"))
    downs = [t_ for t_ in diag["transitions"]
             if t_["replica"] == "r1" and t_["to"] == "down"]
    reasons = {r["data"]["reason"] for r in doctor.load_dump(
        os.path.join(inproc, "r1")) if r["kind"] == "meta"}
    if not downs or not diag["final_window"]["counter_deltas"] or \
            diag["verdict"] not in PM_VERDICTS or "kill" not in reasons:
        fail(f"fleet_postmortem (a): r1's dump: downs {downs}, verdict "
             f"{diag['verdict']}, reasons {sorted(reasons)}, deltas "
             f"{len(diag['final_window']['counter_deltas'])}")
    with open(os.path.join(out, "inproc_r1_diagnosis.json"), "w") as f:
        json.dump(diag, f, indent=1, default=str)
    boxes_a = {n: box_stats(os.path.join(inproc, n))
               for n in sorted(os.listdir(inproc))}
    for n in boxes_a:
        if n != "r1":
            shutil.rmtree(os.path.join(inproc, n))
    a = dict(run_summary(rep, spy.lat), seconds=a_s,
             open_loop_launches=a_launch,
             profile=rep.get("profile"), boxes=boxes_a,
             doctor={"verdict": diag["verdict"],
                     "evidence": diag["evidence"],
                     "down_transitions": len(downs),
                     "final_window_deltas": len(
                         diag["final_window"]["counter_deltas"]),
                     "flush_reasons": sorted(reasons)})
    phase("fleet_postmortem", run="inproc", card=card, **a)
    # (b) through three daemons at fleet_procs' cut
    phase("cut", n=PROC_N, note="fleet_postmortem: loadgen's daemons each "
          "build their own copy at fleet_procs' cut of the 10,000,000 "
          "rows, and serve fleet_procs' batch shapes (1, 8, 32, 128) "
          "where loadgen's are 1 and 8")
    env_before = os.environ.get("RAFT_TPU_BLACKBOX_INTERVAL")
    t0 = time.perf_counter()
    with PostmortemSpy(q_np, procs=True) as spy:
        try:
            rc, rep = run_loadgen(PM_COMMON + PM_PROCS)
        finally:
            if env_before is None:
                os.environ.pop("RAFT_TPU_BLACKBOX_INTERVAL", None)
    b_s = time.perf_counter() - t0
    if any(fp.alive() for fp in spy.pf.processes()):
        fail("fleet_postmortem (b): a daemon outlived the fleet's close")
    # loadgen's workdir (the daemons' boxes, logs, logs of mutations and
    # checkpoints) lives under TMPDIR: r1's box is copied above
    shutil.rmtree(spy.pf.workdir, ignore_errors=True)
    fed = rep.get("federation", {})
    if rc != 0 or rep.get("errors") != 0:
        fail(f"fleet_postmortem (b): rc {rc}, errors {rep.get('errors')}")
    if sorted(fed.get("instances", {})) != ["r0", "r1", "r2"] or \
            fed.get("instances_share_registry") is not False or \
            fed.get("stale") != []:
        fail(f"fleet_postmortem (b): federation section {fed}")
    if spy.errors:
        fail(f"fleet_postmortem (b): {'; '.join(spy.errors)}")
    b_launch = spy.launches
    if not b_launch.get("select_k"):
        fail(f"fleet_postmortem (b): the survivors launched no kernel 2 in "
             f"the open loop: {b_launch}")
    b = dict(run_summary(rep, spy.lat), seconds=b_s,
             open_loop_launches=b_launch,
             scrape_overhead_frac=fed.get("scrape_overhead_frac"),
             federation=fed, killed_replica=rep.get("blackbox", {}).get(
                 "killed_replica"), **spy.checks)
    phase("fleet_postmortem", run="procs", n=PROC_N, card=card, **b)
    phase("fleet_postmortem", card=card,
          seconds=time.perf_counter() - t_phase)
    return a_launch.get("select_k", 0)


def mutate_tail_rows(m, qb, rows, ids, params, launches: dict):
    """Kernel 2 at the mutable tail's shapes on ``m``'s current epoch:
    the column select on the scores of ``qb`` against a delta segment at
    the top rung holding ``rows`` (their ``ids``; the rest of the rung
    empty), and the payload select on the merge's candidates (the main
    phase's k + slack after the tombstone filter, then the delta's k) →
    rows ``select_k@mutate`` and ``select_k_payload@mutate``."""
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.mutate import program
    from raft_tpu_torch.neighbors import plan as plan_mod
    dev, cfg = qb.device, m.cfg
    cap = cfg.delta_capacities[-1]
    dd = torch.zeros((cap, D), device=dev)
    di = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    dd[:rows.shape[0]] = rows
    di[:rows.shape[0]] = torch.from_numpy(ids).to(dev)
    ds = program.delta_scores(qb, dd, (dd * dd).sum(1), di,
                              DistanceType.L2Expanded).contiguous()
    col_row = check_select_k_rows("select_k@mutate", ds, K)
    col_row["launches"] = launches["select_k"]
    index = m.index
    make = plan_mod._flat_builder(index, K + cfg.tombstone_slack, params)[0]
    d_main, i_main = make(qb.shape[0],
                          index.cap_cache[(qb.shape[0], N_PROBES)])[0](qb)
    with m._cond:
        tomb = m._dev.tomb
    dead = program._tombstone_dead(i_main, tomb)
    vd, sel = program._select_min(ds, K)
    id_d = torch.where(torch.isfinite(vd), di[sel.clamp(min=0).long()], -1)
    cand_d = torch.cat([torch.where(dead, float("inf"), d_main), vd],
                       1).contiguous()
    cand_i = torch.cat([torch.where(dead, -1, i_main), id_d],
                       1).to(torch.int32).contiguous()
    pay_row = check_pass_b("select_k_payload@mutate", cand_d, cand_i, K,
                           launches["select_k_payload"],
                           "raft_tpu/ops/pallas_select_k.py:47")
    return [col_row, pay_row]


def http_call(port: int, method: str, path: str, body=None,
              headers=None):
    """One request to the endpoint on its own connection → (status,
    body: parsed JSON, or text for ``/metrics``)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        data = None if body is None else json.dumps(body).encode()
        hdrs = dict(headers or {})
        if data is not None:
            hdrs["Content-Type"] = "application/json"
        conn.request(method, path, body=data, headers=hdrs)
        r = conn.getresponse()
        raw = r.read().decode("utf-8")
        ctype = r.getheader("Content-Type", "")
        return r.status, (json.loads(raw) if ctype == "application/json"
                          else raw)
    finally:
        conn.close()


def parse_prometheus(text: str) -> dict:
    """``{family: summed samples}`` of the Prometheus text; fails on a line
    that does not parse."""
    import re
    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? (\S+)$")
    kinds, sums = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            kinds[name] = kind
            continue
        if not line or line.startswith("#"):
            continue
        m = sample.match(line)
        if m is None:
            fail(f"serve_endpoint: /metrics line does not parse: {line!r}")
        name = m.group(1)
        sums[name] = sums.get(name, 0.0) + float(m.group(3))
    if not kinds:
        fail("serve_endpoint: /metrics has no TYPE line")
    return sums


def run_serve_endpoint(index, q_np, truth, main: dict) -> None:
    """Phase 3 ``serve_endpoint``: the debug endpoint (``obs.serve``) over
    a ``SearchServer`` of the main burst's settings. ``POST /search`` of
    the 256 queries (two 128-query bodies) must give a direct search's
    ids and float32 distances; its trace must be parented by
    ``raft.serve.http``; a closed-loop burst of 512 one-query POSTs from
    8 threads must lose no request, and the metrics history sampled
    through it must give its rate within 25% of its QPS; ``/healthz``
    must answer 200, then 503 naming the breach of a latency objective
    that cannot hold; ``/metrics`` must parse with the registry's request
    total, ``/debug/profile`` answer 200; kernels 2 and 3 must launch."""
    from raft_tpu_torch import obs, ops
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import history, profiler, recorder, slo, spans
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    t_phase = time.perf_counter()
    was_tracing = (spans.trace_enabled(), spans.trace_sample_rate())
    spans.set_trace_enabled(True)
    spans.set_trace_sample_rate(1.0)
    profiler.disable_profiling()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=ivf_flat.SearchParams(n_probes=N_PROBES),
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0))
    ep = obs.serve(port=0, searcher=srv)
    tracker = None
    ops.reset_launch_counts()
    try:
        code, health = http_call(ep.port, "GET", "/healthz")
        if code != 200 or health.get("status") != "ok":
            fail(f"serve_endpoint: /healthz on the quiet server: {code} "
                 f"{health}")
        # ids over HTTP, against direct searches of the same batches
        http_d, http_i, trace_ids = [], [], []
        for s in range(0, N_QUERIES, 128):
            code, body = http_call(ep.port, "POST", "/search",
                                   {"queries": q_np[s:s + 128].tolist()})
            if code != 200:
                fail(f"serve_endpoint: POST /search answered {code}: {body}")
            http_d.append(np.asarray(body["distances"], np.float32))
            http_i.append(np.asarray(body["ids"], np.int64))
            trace_ids.append(body["trace_id"])
        direct = [srv.search(q_np[s:s + 128], timeout=600)
                  for s in range(0, N_QUERIES, 128)]
        for (d, i), hd, hi in zip(direct, http_d, http_i):
            if not np.array_equal(hi, np.asarray(i)) or \
                    not np.array_equal(hd, np.asarray(d, np.float32)):
                fail("serve_endpoint: POST /search ids or distances differ "
                     "from a direct search of the same queries")
        ids_http = np.concatenate(http_i)
        recall = float(np.mean([len(set(ids_http[r]) & set(truth[r]))
                                for r in range(N_QUERIES)])) / K
        # the trace: the handler's fragment, and the request's under it
        tid = trace_ids[0]
        code, chrome = http_call(
            ep.port, "GET", f"/debug/requests?trace={tid}&format=chrome")
        http_spans = [e for e in chrome.get("traceEvents", ())
                      if e.get("name") == "raft.serve.http"] \
            if code == 200 else []
        # the dispatcher records a request's trace just after it sets the
        # result, so the fragment may land a moment after the response
        for _ in range(100):
            code_f, frag = http_call(ep.port, "GET",
                                     f"/debug/requests?trace={tid}&all=1")
            if any(f.get("name") == "raft.serve.request"
                   for f in frag.get("fragments", ())):
                break
            time.sleep(0.01)
        stitched = recorder.stitch_chrome_trace(frag.get("fragments", ()))
        evs = {e["args"]["span_id"]: e for e in stitched["traceEvents"]
               if e.get("ph") == "X"}
        served = [e for e in evs.values()
                  if e["name"] == "raft.serve.request"]
        if len(http_spans) != 1 or code_f != 200 or not served or any(
                evs.get(e["args"].get("parent_id"), {}).get("name")
                != "raft.serve.http"
                or e["args"]["parent_id"] != http_spans[0]["args"]["span_id"]
                for e in served):
            fail(f"serve_endpoint: trace {tid}: {code} with "
                 f"{len(http_spans)} raft.serve.http spans, fragments "
                 f"{[f.get('name') for f in frag.get('fragments', ())]}")
        # the cost of HTTP and JSON on a 128-query batch, in turns
        post_ms, direct_ms = [], []
        batch = q_np[:128]
        for _ in range(HTTP_BATCH_ROUNDS):
            t0 = time.perf_counter()
            code, body = http_call(ep.port, "POST", "/search",
                                   {"queries": batch.tolist()})
            np.asarray(body["distances"], np.float32)
            post_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            srv.search(batch, timeout=600)
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        # in process at the HTTP burst's concurrency
        before = obs.snapshot()
        lat8, wall8, errors = closed_loop(
            lambda r: srv.search(q_np[r % N_QUERIES], timeout=600),
            HTTP_THREADS)
        if errors:
            fail(f"serve_endpoint: in-process burst: {errors[0]}")
        inproc_row = dict(latency_row(lat8, wall8), batches=counter_deltas(
            before, obs.snapshot(), "raft.serve.batch"))
        # the HTTP burst, sampled by the history and the SLO tracker
        hist = history.enable_history(interval_s=HISTORY_INTERVAL_S)
        clock = {"t": 0.0}
        tracker = slo.SLOTracker(
            [slo.Objective("endpoint_p999_1ms", "latency",
                           target=SLO_TARGET, threshold_ms=SLO_THRESHOLD_MS,
                           windows=(10.0,))],
            clock=lambda: clock["t"], start=False)
        tracker.tick()
        seq0 = hist.tick()

        def post_one(r):
            code, body = http_call(
                ep.port, "POST", "/search",
                {"queries": [q_np[r % N_QUERIES].tolist()]})
            if code != 200:
                raise RuntimeError(f"{code}: {body}")

        before = obs.snapshot()
        lat_h, wall_h, errors = closed_loop(post_one, HTTP_THREADS)
        seq1 = hist.tick()
        http_batches = counter_deltas(before, obs.snapshot(),
                                      "raft.serve.batch")
        clock["t"] = 10.0
        tracker.tick()
        if errors:
            fail(f"serve_endpoint: {len(errors)} of {N_REQUESTS} POSTs "
                 f"failed or were dropped, first {errors[0]}")
        frames = {f["seq"]: f for f in hist.frames_since(seq0 - 1)}
        window = frames[seq1]["t_mono"] - frames[seq0]["t_mono"] + 1e-6
        code, hbody = http_call(
            ep.port, "GET",
            f"/debug/history?name=raft.serve.requests&window={window:.6f}")
        rate = (hbody.get("series", {}).get("raft.serve.requests.total", {})
                .get("rate_per_s") if code == 200 else None)
        http_row = dict(latency_row(lat_h, wall_h), batches=http_batches)
        if rate is None or abs(rate - http_row["qps"]) > \
                HISTORY_RATE_TOL * http_row["qps"]:
            fail(f"serve_endpoint: /debug/history rate {rate} against the "
                 f"burst's {http_row['qps']} QPS ({code} {hbody})")
        history.disable_history()
        # the objective that cannot hold
        code_s, slo_body = http_call(ep.port, "GET", "/debug/slo")
        rep = slo_body.get("objectives", {}).get("endpoint_p999_1ms", {})
        code_h, health = http_call(ep.port, "GET", "/healthz")
        breach = "raft.slo.breach{objective=endpoint_p999_1ms}"
        if code_s != 200 or not rep.get("breach") or code_h != 503 or \
                breach not in health.get("slo", {}).get("breaches", ()):
            fail(f"serve_endpoint: SLO breach not served: /debug/slo "
                 f"{code_s} {slo_body}, /healthz {code_h} {health}")
        tracker.close()
        tracker = None
        # metrics and the profile
        code, text = http_call(ep.port, "GET", "/metrics")
        total = obs.counter_sum(obs.snapshot(), "raft.serve.requests.total")
        sums = parse_prometheus(text) if code == 200 else {}
        if sums.get("raft_serve_requests_total_total") != total:
            fail(f"serve_endpoint: /metrics {code}: request total "
                 f"{sums.get('raft_serve_requests_total_total')} against "
                 f"the registry's {total}")
        code_p, _ = http_call(ep.port, "GET", "/debug/profile")
        if code_p != 200:
            fail(f"serve_endpoint: /debug/profile answered {code_p}")
    finally:
        if tracker is not None:
            tracker.close()
        history.disable_history()
        ep.close()
        srv.close()
        spans.set_trace_enabled(was_tracing[0])
        spans.set_trace_sample_rate(was_tracing[1])
    launches = ops.launch_counts()
    check_launched("serve_endpoint", launches, ("select_k", "ivf_scan"))
    phase("serve_endpoint", url_bound="127.0.0.1",
          threads=HTTP_THREADS, requests=N_REQUESTS,
          http=http_row, inproc_8=inproc_row,
          main={k_: main[k_] for k_ in ("qps", "p50_ms", "p99_ms")},
          post_128_ms=float(np.median(post_ms)),
          direct_128_ms=float(np.median(direct_ms)),
          http_json_128_ms=float(np.median(post_ms) - np.median(direct_ms)),
          **{f"http_recall_at_{K}": recall},
          history_rate_per_s=rate, history_window_s=window,
          slo=rep, metrics_families=len(sums),
          launches={k_: v for k_, v in launches.items() if v},
          seconds=time.perf_counter() - t_phase)


def run_flat(x, q, q_np, truth, args):
    """Phase 3: IVF-Flat build + serving; the fused scan checked against
    its plain version on the served index afterwards."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = ivf_flat.build(x, ivf_flat.IndexParams(
        n_lists=N_LISTS, kmeans_n_iters=KMEANS_ITERS))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    build_shapes = l2nn_shapes()
    ladder_s, served, burst = serve_flat(index, q_np, truth, x.shape[0],
                                         "flat" if args.profile else "")
    launches = ops.launch_counts()
    check_launched("IVF-Flat", launches, ("fused_l2_nn", "select_k",
                                          "ivf_scan"))
    phase("main", n=x.shape[0], dim=D, n_lists=N_LISTS, max_list=
          int(index.lists_data.shape[1]), build_s=build_s, ladder_s=ladder_s,
          **served, build_launches=build_launches,
          build_fused_l2_nn_shapes=build_shapes, burst_launches=burst,
          launches=launches,
          mem_allocated_gb=torch.cuda.memory_allocated() / 1e9,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    run_serve_endpoint(index, q_np, truth, served)
    run_serve_faults(index, q_np, truth, x.shape[0], served)
    quality_row = run_serve_quality(index, q_np, truth, x.shape[0], served)
    run_serve_obs(index, q_np, truth, served)
    mutate_rows = run_serve_mutate(index, x, q, q_np, served, args.seed)
    tiered_rows = run_serve_tiered(index, x, q, q_np, truth, served)
    run_mutate_durable(index, x, q, args.seed)
    run_serve_fleet(index, q, q_np, served, args.seed)
    run_fleet_procs(q_np, args.seed)
    # kernel 2 at the probe-major coarse select's largest shape (32 rows),
    # with the launches of fleet_postmortem's in-process open loop
    pm_row = check_select_k(q[:32], index.centers, N_PROBES,
                            "select_k@probe_major")
    pm_row["launches"] = run_fleet_postmortem(q_np)
    wide_launches = run_wide_flat(index, q, truth)
    row, wide_row, rows = check_flat_scans(index, q)
    pass_b = check_pass_b("select_k_payload@ivf_flat", *rows, K,
                          launches["ivf_scan"],
                          "raft_tpu/ops/pallas_ivf_scan.py:241")
    del index, rows
    free_phase("flat")
    return ([row, pass_b, quality_row, pm_row] + mutate_rows + tiered_rows,
            launches,
            [wide_row], wide_launches, served)


def nccl_group_check(mesh) -> dict:
    """A one-rank NCCL group through ``initialize_distributed``: its
    allreduce, allgather, alltoall and bcast of one integer block equal
    the same body's on a one-rank in-process mesh of the card."""
    import socket
    from raft_tpu_torch import comms, parallel
    from raft_tpu_torch.comms import bootstrap
    from raft_tpu_torch.parallel.mesh import P

    def body(c, v):
        return torch.stack([c.allreduce(v), c.allgather(v)[0],
                            c.alltoall(v), c.bcast(v, root=0)])

    x = torch.arange(16, dtype=torch.int32,
                     device=mesh.devices_flat[0]).reshape(8, 2)
    one = parallel.make_mesh(devices=[mesh.devices_flat[0]])
    c1 = comms.build_comms(one, abort_timeout_s=60.0)
    want = parallel.shard_map(lambda v: body(c1, v), one, P("data"),
                              P())(x).cpu()
    one.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    comms.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        pm = parallel.make_mesh()
        cp = comms.build_comms(pm, abort_timeout_s=60.0)
        got = parallel.shard_map(lambda v: body(cp, v), pm, P("data"),
                                 P())(x).cpu()
        backend = torch.distributed.get_backend()
    finally:
        bootstrap.shutdown_distributed()
    if not torch.equal(got, want):
        fail("serve_dist: the NCCL group's collectives differ from the "
             "in-process mesh's")
    return {"backend": backend, "ranks": 1, "equal": True,
            "seconds": time.perf_counter() - t0}


def sharded_build(x, mesh):
    """``sharded_ivf_flat_build`` of every row over ``mesh`` → (index,
    its phase fields): seconds by part (each part synchronised), kernel
    1's launches by shape, peak device memory beside the reckoning."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.parallel import ivf as pivf
    n, d = x.shape
    # the reckoning, before the call: the padded lists (n_lists x the
    # widest list x d x 4 B, ~2.3 x the mean width on this mixture),
    # the pre-exchange buckets and the alltoall's copy about as much
    # again each, the trainset (half the rows) and the rows themselves
    width = 2.4 * n / N_LISTS
    lists_gb = N_LISTS * width * d * 4 / 1e9
    reckon_gb = 3 * lists_gb + 1.5 * x.numel() * 4 / 1e9
    phase("serve_dist_reckoning", lists_gb=lists_gb, peak_gb=reckon_gb)
    parts = {"train": 0.0, "label_widths": 0.0, "bucket_exchange": 0.0}
    saved = {}
    for attr, part in (("_train_coarse_sharded", "train"),
                       ("_label_and_widths", "label_widths"),
                       ("_run_lbuild", "bucket_exchange")):
        fn = saved[attr] = getattr(pivf, attr)

        def wrapped(*a, _fn=fn, _part=part, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            parts[_part] += time.perf_counter() - t0
            return out
        setattr(pivf, attr, wrapped)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        index = pivf.sharded_ivf_flat_build(x, ivf_flat.IndexParams(
            n_lists=N_LISTS, kmeans_n_iters=KMEANS_ITERS), mesh=mesh)
        torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            setattr(pivf, attr, fn)
    build_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_launched("sharded build", launches, ("fused_l2_nn",))
    return index, dict(
        build_s=build_s, parts_s=parts, build_launches=launches,
        build_fused_l2_nn_shapes=l2nn_shapes(),
        max_list=int(index.lists_data.shape[1]),
        mem_base_gb=base / 1e9,
        mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        mem_reckoned_gb=reckon_gb)


def check_sharded_lists(index, x) -> dict:
    """Every row id in exactly one list, ``list_sizes`` summing to n, and
    a sample's lists kernel 1's plain assignment (bf16x3, the build's
    arithmetic) to the built centres, near-ties aside."""
    from raft_tpu_torch.ops import fused_l2_nn as nn_op
    n = x.shape[0]
    dev = x.device
    ids = index.lists_indices.gather(dev)
    valid = ids >= 0
    flat = ids[valid].long()
    if flat.numel() != n or not torch.equal(
            torch.sort(flat).values, torch.arange(n, device=dev)):
        fail("serve_dist: the sharded lists do not hold every id once")
    sizes = index.list_sizes.gather(dev)
    if int(sizes.sum()) != n or not torch.equal(
            sizes.long(), valid.sum(1)):
        fail("serve_dist: list_sizes do not count the lists' rows")
    where = torch.empty(n, dtype=torch.long, device=dev)
    where[flat] = torch.nonzero(valid)[:, 0]
    del ids, valid, flat
    g = torch.Generator(device=dev).manual_seed(13)
    rows = torch.randperm(n, generator=g, device=dev)[:DIST_CHECK_ROWS]
    xs = x[rows]
    centers = index.centers.gather(dev)
    lab, _ = nn_op.fused_l2_nn_plain(xs, centers, False, "bf16x3")
    got = where[rows]
    same = got == lab.long()
    # a row in another list than the plain assignment's is a near-tie:
    # its two centres' distances within RTOL of the expanded-L2 scale
    d_got = ((xs - centers[got]) ** 2).sum(1)
    d_lab = ((xs - centers[lab.long()]) ** 2).sum(1)
    scale = (xs * xs).sum(1) + (centers * centers).sum(1).max()
    ties = (~same) & ((d_got - d_lab).abs() <= 4 * RTOL * scale)
    agree = float(same.float().mean())
    if agree < MIN_ID_AGREEMENT or not bool((same | ties).all()):
        fail(f"serve_dist: sampled lists agree with kernel 1's plain "
             f"assignment on {agree:.6f} (floor {MIN_ID_AGREEMENT}), "
             f"{int((~same & ~ties).sum())} not near-ties")
    return {"rows_checked": DIST_CHECK_ROWS, "agreement": agree,
            "near_ties": int(ties.sum())}


def dist_recall(ids: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean([len(set(ids[r]) & set(truth[r % N_QUERIES]))
                          for r in range(len(ids))])) / K


def capture_merge_rows(index, q, mesh, params):
    """One 128-query f32-merge search, the cross-shard merge's candidate
    rows captured (kernel 2's payload select at (128, 8 x 32))."""
    from raft_tpu_torch.ops import select_k as op
    from raft_tpu_torch.parallel import ivf as pivf
    rows = []
    orig = op.select_k_payload

    # (a dispatch a watchdog abandoned may still run a 1-row search)
    def capture(v, ids, k, sqrt=False):
        if not rows and tuple(v.shape) == (128, mesh.shape["data"] * k):
            rows.append((v.clone(), ids.clone()))
        return orig(v, ids, k, sqrt)
    op.select_k_payload = capture
    try:
        pivf.distributed_ivf_flat_search(index, q[:128], K, params,
                                         mesh=mesh, merge="f32")
        torch.cuda.synchronize()
    finally:
        op.select_k_payload = orig
    if not rows:
        fail("serve_dist: no cross-shard merge rows captured")
    return rows[0]


def failover_round(srv, q_np, mesh, index) -> dict:
    """``stall_shard`` plus its suspect gauge: every request served
    partial (coverage 1 - the rank's row share, the quality detail naming
    it), none failed; then the gauge cleared, the full mesh back with no
    plan built."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.testing import faults
    sizes = index.list_sizes.gather("cpu").double()
    per = sizes.numel() // mesh.shape["data"]
    r = DIST_STALL_RANK
    want_cov = 1.0 - float(sizes[r * per:(r + 1) * per].sum() / sizes.sum())
    before = obs.snapshot()
    results, errors = [None] * DIST_FAILOVER_REQUESTS, []
    t0 = time.perf_counter()
    with faults.stall_shard(r, seconds=DIST_STALL_S):
        def call(j):
            try:
                results[j] = srv.search(q_np[j], timeout=120)
            except Exception as e:  # reported below
                errors.append(repr(e))
        pool = [threading.Thread(target=call, args=(j,), daemon=True)
                for j in range(DIST_FAILOVER_REQUESTS)]
        for th in pool:
            th.start()
        for th in pool:
            th.join()
        detail = srv._quality_detail()
        excluded = srv.excluded_ranks
    partial_s = time.perf_counter() - t0
    mid = obs.snapshot()
    if errors:
        fail(f"serve_dist failover: {len(errors)} requests failed, first "
             f"{errors[0]}")
    covs = sorted({round(res.coverage, 6) for res in results})
    if not all(getattr(res, "partial", False) for res in results):
        fail("serve_dist failover: a request under the stall was not "
             "served partial")
    if any(abs(c - want_cov) > 1e-4 for c in covs):
        fail(f"serve_dist failover: coverage {covs} != {want_cov}")
    if excluded != (r,) or detail != str(r):
        fail(f"serve_dist failover: excluded {excluded}, quality detail "
             f"{detail!r}")
    time.sleep(2 * DIST_FAILOVER["failover_probe_ms"] / 1e3)
    t1 = time.perf_counter()
    back = [srv.search(q_np[j], timeout=120) for j in range(8)]
    recover_s = time.perf_counter() - t1
    after = obs.snapshot()
    if any(getattr(b, "partial", False) for b in back) or srv.excluded_ranks:
        fail("serve_dist failover: the full mesh did not come back")
    built = {name: after["counters"].get(name, 0)
             - before["counters"].get(name, 0)
             for name in ("raft.plan.build.total", "raft.parallel.plan.misses")}
    if any(built.values()):
        fail(f"serve_dist failover: plans built on the failure path {built}")
    return {"stalled_rank": r, "requests": DIST_FAILOVER_REQUESTS,
            "partial": DIST_FAILOVER_REQUESTS, "failed": 0,
            "coverage": covs, "coverage_want": want_cov,
            "shards_served": f"{mesh.shape['data'] - 1}/{mesh.shape['data']}",
            "quality_detail": detail, "partial_round_s": partial_s,
            "recover_s": recover_s,
            "failover_deltas": counter_deltas(mid, after,
                                              "raft.serve.failover")
            | counter_deltas(before, mid, "raft.serve.failover"),
            "plans_built": built}


def run_serve_dist(x, q, q_np, truth, main: dict, profile: bool = False):
    """Phase 3a (module docstring) → kernel rows."""
    from raft_tpu_torch import comms, obs, ops, parallel
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.serve import DistributedSearchServer, ServeConfig
    from raft_tpu_torch.tools import loadgen
    t_phase = time.perf_counter()
    # loadgen --server dist's mesh: every card once, else eight logical
    # ranks on the one card
    mesh = parallel.make_mesh(devices=loadgen.dist_devices(x.device))
    n_shards = mesh.shape["data"]
    phase("serve_dist_mesh", device_count=torch.cuda.device_count(),
          mesh=repr(mesh), ranks=n_shards,
          logical_ranks_per_card=n_shards // len(set(mesh.devices_flat)))
    # 1. collectives
    t0 = time.perf_counter()
    checks = {name: getattr(comms, name)(mesh)
              for name in comms.collective_checks.__all__}
    if not all(v is True for v in checks.values()):
        fail(f"serve_dist: collective checks {checks}")
    nccl = nccl_group_check(mesh)
    sample = sample_rows(x, KM_ROWS, 11)
    runs = [kmeans_balanced.balanced_kmeans_sharded(
        sample, N_LISTS, KMEANS_ITERS, mesh=mesh) for _ in range(2)]
    if not torch.equal(runs[0], runs[1]):
        fail("serve_dist: two sharded trainer runs differ")
    del runs
    phase("serve_dist_collectives", checks=checks, nccl=nccl,
          sharded_trainer_bit_identical=True,
          seconds=time.perf_counter() - t0)
    # 2. the sharded build
    index, built = sharded_build(x, mesh)
    lists = check_sharded_lists(index, x)
    phase("serve_dist_build", n=x.shape[0], n_lists=N_LISTS, ranks=n_shards,
          **built, lists=lists)
    # 3. serving
    params = ivf_flat.SearchParams(n_probes=DIST_PROBES)
    cfg = ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                      max_wait_ms=2.0, probes_ladder=DIST_LADDER)
    t0 = time.perf_counter()
    srv = DistributedSearchServer.from_sharded_index(
        index, q_np[:128], K, params, mesh=mesh, config=cfg, merge="int8")
    ladder_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    before = obs.snapshot()
    served_d, served, lat, wall = serve_burst(srv, q_np)
    after = obs.snapshot()
    burst_launches = ops.launch_counts()
    check_launched("serve_dist", burst_launches,
                   ("select_k", "select_k_payload"))
    flat = {name: after["counters"].get(name, 0)
            - before["counters"].get(name, 0)
            for name in ("raft.parallel.plan.misses", "raft.plan.build.total",
                         "raft.plan.cache.misses")}
    if any(flat.values()):
        fail(f"serve_dist: the burst prepared plans {flat}")
    ratio = after["gauges"].get("raft.serve.dist.merge.ratio")
    if ratio is None:
        fail("serve_dist: raft.serve.dist.merge.ratio not recorded")
    if (served < 0).any() or (served >= x.shape[0]).any() or \
            not np.isfinite(served_d).all():
        fail("serve_dist: served ids or distances out of range")
    burst_recall = dist_recall(served, truth)
    if burst_recall < RECALL_FLOOR:
        fail(f"serve_dist: recall@{K} = {burst_recall} < {RECALL_FLOOR}")
    # the 256 queries once the load is gone (rung 0), against a direct
    # search; the f32 merge's recall beside the int8 merge's
    t1 = time.perf_counter()
    while obs.snapshot()["gauges"].get("raft.serve.degrade.level", 0) and \
            time.perf_counter() - t1 < 10:
        srv.search(q_np[:1], timeout=120)
        time.sleep(0.1)
    got = np.concatenate([srv.search(q_np[s:s + 128], timeout=300)[1]
                          for s in range(0, N_QUERIES, 128)])
    recalls = {}
    for merge in ("int8", "f32"):
        ids = np.concatenate([pivf.distributed_ivf_flat_search(
            index, q[s:s + 128], K, params, mesh=mesh,
            merge=merge)[1].cpu().numpy() for s in range(0, N_QUERIES, 128)])
        recalls[merge] = dist_recall(ids, truth)
        if merge == "int8" and not np.array_equal(got, ids):
            fail(f"serve_dist: served ids differ from a direct search on "
                 f"{int((got != ids).sum())} entries")
    if abs(recalls["f32"] - recalls["int8"]) > 0.005:
        fail(f"serve_dist: f32 merge recall {recalls['f32']} vs int8 "
             f"{recalls['int8']} (budget 0.005)")
    if profile:
        profile_burst(srv, q_np, "dist")
    srv.close()
    phase("serve_dist", **latency_row(lat, wall), requests=N_REQUESTS,
          threads=N_THREADS, ladder_s=ladder_s,
          **{f"recall_at_{K}": burst_recall},
          direct_recall=recalls, served_equals_direct=True,
          merge_ratio=ratio, steady_state=flat,
          batches=counter_deltas(before, after, "raft.serve.batch"),
          dist=counter_deltas(before, after, "raft.serve.dist"),
          burst_launches=burst_launches,
          single_device_main={key: main.get(key) for key in
                              ("qps", "p50_ms", "p99_ms",
                               f"recall_at_{K}")},
          mem_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    # 4. failover
    t0 = time.perf_counter()
    fsrv = DistributedSearchServer.from_sharded_index(
        index, q_np[:128], K, params, mesh=mesh,
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0, probes_ladder=DIST_LADDER,
                           **DIST_FAILOVER), merge="int8")
    fo_ladder_s = time.perf_counter() - t0
    try:
        fo = failover_round(fsrv, q_np, mesh, index)
    finally:
        fsrv.close()
    phase("serve_dist_failover", ladder_s=fo_ladder_s, **fo)
    # 5. kernel rows at the path's shapes
    local_centers = index.centers.blocks[0].contiguous()
    rows_d, rows_i = capture_merge_rows(index, q, mesh, params)
    # a rank's share of the trainer's rows (the build trains on half the
    # rows, kmeans_trainset_fraction 0.5)
    m_local = max(N_LISTS, x.shape[0] // 2) // n_shards
    rows = [check_fused_l2_nn(x[:m_local], index.centers.gather(x.device),
                              "fused_l2_nn@sharded"),
            check_select_k(q, local_centers, DIST_PROBES, "select_k@dist"),
            check_pass_b("select_k_payload@dist", rows_d, rows_i, K,
                         burst_launches["select_k_payload"],
                         "raft_tpu/ops/pallas_select_k.py:47")]
    rows[0]["launches"] = built["build_launches"]["fused_l2_nn"]
    rows[1]["launches"] = burst_launches["select_k"]
    # serve_dist_mutate serves the same lists from one device (handed over
    # in a list it empties, so no caller keeps the first epoch alive)
    t0 = time.perf_counter()
    single = [pivf.gather_index(index)]
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    # the servers' ladders hold the index (and views of its shards)
    del srv, fsrv, index, local_centers, rows_d, rows_i, sample
    mesh.close()
    free_phase("serve_dist")
    phase("serve_dist_done", seconds=time.perf_counter() - t_phase,
          gather_s=gather_s)
    return rows, single


def dist_search_all(plan, queries, batch: int = 128) -> np.ndarray:
    """Every row of ``queries`` through a mesh-wide mutable plan of shape
    ``batch`` (the last batch padded with its own first rows) → ids."""
    out = []
    for s in range(0, queries.shape[0], batch):
        qb = queries[s:s + batch]
        n = qb.shape[0]
        if n < batch:
            qb = torch.cat([qb, qb[:1].expand(batch - n, -1)])
        out.append(plan.search(qb.cpu().numpy(),
                               block=True)[1][:n].cpu().numpy())
    return np.concatenate(out)


@contextlib.contextmanager
def counted_misses(owner, attr: str):
    """Count the plan misses (``raft.parallel.plan.misses``,
    ``raft.plan.cache.misses``) that happen inside calls of ``owner``'s
    ``attr`` → a dict updated in the scope."""
    from raft_tpu_torch import obs
    names = ("raft.parallel.plan.misses", "raft.plan.cache.misses")
    inside = dict.fromkeys(names, 0)
    fn = getattr(owner, attr)

    def wrapped(*a, **kw):
        before = obs.snapshot()["counters"]
        try:
            return fn(*a, **kw)
        finally:
            after = obs.snapshot()["counters"]
            for name in names:
                inside[name] += after.get(name, 0) - before.get(name, 0)
    setattr(owner, attr, wrapped)
    try:
        yield inside
    finally:
        setattr(owner, attr, fn)


def plan_misses(before: dict, after: dict) -> dict:
    return {name: after["counters"].get(name, 0)
            - before["counters"].get(name, 0)
            for name in ("raft.parallel.plan.misses",
                         "raft.plan.cache.misses")}


def run_serve_dist_mutate(box, x, q, q_np, seed: int):
    """Phase 3d (module docstring) over the index ``box`` holds (taken
    out of it) → kernel rows (none: the mesh tail's kernel 2 shapes are
    ``serve_mutate``'s, (128, 16384) k=32 and (128, 80) k=32; its
    launches are in the phase line)."""
    from raft_tpu_torch import mutate, obs, ops, parallel
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.mutate import compact as compact_mod
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.serve import DistributedSearchServer, ServeConfig
    from raft_tpu_torch.tools import loadgen
    t_phase = time.perf_counter()
    index = box.pop()
    n, dev = x.shape[0], x.device
    mesh = parallel.make_mesh(devices=loadgen.dist_devices(dev))
    # the reckoning, before the calls: the mesh rebuild holds the old
    # epoch's lists, the live rows, and the sharded build's buckets, its
    # alltoall's copy and its serving lists at once (each ~ the padded
    # lists), beside the dataset
    lists_gb = index.lists_data.numel() * 4 / 1e9
    rows_gb = x.numel() * 4 / 1e9
    reckon_gb = rows_gb + lists_gb + rows_gb + 3 * lists_gb
    phase("serve_dist_mutate_reckoning", lists_gb=lists_gb, rows_gb=rows_gb,
          rebuild_peak_gb=reckon_gb)
    gen = np.random.default_rng(seed + 201)
    picked = gen.choice(n, MUTATE_DELETES + MUTATE_REUPSERTS, replace=False)
    re_ids = picked[:MUTATE_REUPSERTS].astype(np.int32)
    del_ids = picked[MUTATE_REUPSERTS:].astype(np.int64)
    new_rows = mixture_rows(n, MUTATE_UPSERTS, seed, seed + 202, dev)
    re_rows = mixture_rows(n, MUTATE_REUPSERTS, seed, seed + 203, dev)
    new_np, re_np = new_rows.cpu().numpy(), re_rows.cpu().numpy()
    params = ivf_flat.SearchParams(n_probes=DIST_PROBES)
    m = mutate.MutableIndex(index, k=K, params=params)
    del index
    t0 = time.perf_counter()
    srv = DistributedSearchServer.from_mutable(
        m, q_np[:128], mesh=mesh, config=ServeConfig(
            batch_sizes=BATCH_SIZES, max_queue=512, max_wait_ms=2.0,
            probes_ladder=DIST_LADDER), merge="int8")
    ladder_s = time.perf_counter() - t0
    plan = srv.ladder.plan_for(128, 0)[1]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    errors, got, rounds = [], [], []
    folded = threading.Event()

    def compactor():
        # one fold once half the writes are in the delta
        while m.stats()["delta_used"] < MUTATE_UPSERTS // 2 and \
                writer.is_alive():
            time.sleep(0.01)
        try:
            m.compact()
        except Exception as e:  # reported after the join
            errors.append(repr(e))
        folded.set()

    ops.reset_launch_counts()
    before = obs.snapshot()
    with timed_parts([(compact_mod, "purge", "purge"),
                      (ivf_flat, "extend", "extend"),
                      (mutate.MutableIndex, "_prewarm_epoch", "prewarm"),
                      (mutate.MutableIndex, "_swap_epoch", "swap")]
                     ) as (fold_s, fold_calls), \
            counted_misses(mutate.MutableIndex, "_prewarm_epoch") as warm:
        writer = threading.Thread(target=lambda: got.extend(mutate_writer(
            m, new_np, del_ids, re_ids, re_np, errors)), daemon=True)
        writer.start()
        comp = threading.Thread(target=compactor, daemon=True)
        comp.start()
        deadline = time.perf_counter() + MUTATE_TIMEOUT_S
        while True:
            rounds.append(serve_burst(srv, q_np))
            if not writer.is_alive() and folded.is_set() and len(rounds) >= 2:
                break
            if time.perf_counter() > deadline:
                fail(f"serve_dist_mutate: not quiet after {len(rounds)} "
                     f"bursts: {m.stats()}")
        writer.join(timeout=60)
        comp.join(timeout=60)
    after = obs.snapshot()
    launches = ops.launch_counts()
    if errors or writer.is_alive() or comp.is_alive():
        fail(f"serve_dist_mutate: the writer or the fold failed: "
             f"{errors[:1]}")
    misses = plan_misses(before, after)
    if misses != warm or m.epoch != 1:
        fail(f"serve_dist_mutate: plan misses {misses}, {warm} inside the "
             f"compaction's warm-up; epoch {m.epoch}")
    check_launched("serve_dist_mutate", launches,
                   ("fused_l2_nn", "select_k", "select_k_payload"))
    up_ids = np.concatenate(got)
    if up_ids.shape[0] != MUTATE_UPSERTS:
        fail(f"serve_dist_mutate: {up_ids.shape[0]} upserts acknowledged")
    # serial checks on the quiet index, through the served plan
    t0 = time.perf_counter()
    sample = gen.choice(MUTATE_UPSERTS, min(DIST_SELF_HIT_ROWS,
                                            MUTATE_UPSERTS), replace=False)
    self_new = dist_search_all(plan, new_rows[torch.from_numpy(sample).to(
        dev)])[:, 0] == up_ids[sample]
    self_re = dist_search_all(plan, re_rows)[:, 0] == re_ids
    self_hit = float(np.concatenate([self_new, self_re]).mean())
    if self_hit < MUTATE_SELF_HIT:
        fail(f"serve_dist_mutate: upserted rows find themselves at rank 0 "
             f"on {self_hit:.5f} < {MUTATE_SELF_HIT}")
    dead_sample = del_ids[:DIST_DEAD_ROWS]
    dead = dist_search_all(plan, x[torch.from_numpy(dead_sample).to(dev)])
    if np.isin(dead, del_ids).any():
        fail(f"serve_dist_mutate: {int(np.isin(dead, del_ids).sum())} "
             f"deleted ids returned")
    t1 = time.perf_counter()
    while obs.snapshot()["gauges"].get("raft.serve.degrade.level", 0) and \
            time.perf_counter() - t1 < 10:
        srv.search(q_np[:1], timeout=120)
        time.sleep(0.1)
    for s in range(0, N_QUERIES, 128):
        srv_i = srv.search(q_np[s:s + 128], timeout=600)[1]
        dir_i = plan.search(q_np[s:s + 128], block=True)[1].cpu().numpy()
        if not np.array_equal(np.asarray(srv_i), dir_i):
            fail("serve_dist_mutate: the server's ids differ from a direct "
                 "_MutableDistPlan.search of the same batch")
    serial_s = time.perf_counter() - t0
    # recall@K of the live view against the live corpus's exact top-K
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[torch.from_numpy(picked).to(dev)] = False
    live_ids = np.concatenate([np.flatnonzero(keep.cpu().numpy()), re_ids,
                               up_ids])
    live = torch.cat([x[keep], re_rows, new_rows])
    truth_live = live_ids[brute_force_knn(
        live, q, K, DistanceType.L2Expanded, mode="exact",
        device=dev)[1].cpu().numpy()]
    del live, keep
    got_live = dist_search_all(plan, q)
    recall = dist_recall(got_live, truth_live)
    if recall < RECALL_FLOOR:
        fail(f"serve_dist_mutate: live recall@{K} = {recall}")
    lat = np.concatenate([r[2] for r in rounds])
    wall = sum(r[3] for r in rounds)
    p50, p99 = (float(v) * 1e3 for v in np.percentile(lat, [50, 99]))
    phase("serve_dist_mutate", n=n, upserts=MUTATE_UPSERTS,
          deletes=MUTATE_DELETES, reupserts=MUTATE_REUPSERTS,
          ladder_s=ladder_s, bursts=len(rounds), requests=len(lat),
          qps=len(lat) / wall, p50_ms=p50, p99_ms=p99,
          burst_qps=[N_REQUESTS / r[3] for r in rounds],
          plan_misses=misses, warmup_misses=warm, fold_s=fold_s,
          fold_calls=fold_calls, epoch=m.epoch,
          **{f"live_recall_at_{K}": recall}, self_hit_rank0=self_hit,
          self_hit_rows=int(sample.size + re_ids.size),
          deleted_checked=int(dead_sample.size), deleted_returned=0,
          serial_s=serial_s, launches=launches,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    # the mesh rebuild (the cache's free blocks back first: eight rank
    # streams each keep their own)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_parts([(compact_mod, "reconstruct_rows", "reconstruct"),
                      (pivf, "sharded_ivf_flat_build", "sharded_build"),
                      (compact_mod, "_renumber", "renumber"),
                      (mutate.MutableIndex, "_prewarm_epoch", "prewarm"),
                      (mutate.MutableIndex, "_swap_epoch", "swap")]
                     ) as (rebuild_s, _):
        if not m.compact(mode="rebuild", mesh=mesh):
            fail("serve_dist_mutate: the mesh rebuild did not run")
    torch.cuda.synchronize()
    rebuild_total = time.perf_counter() - t0
    rebuild_peak = torch.cuda.max_memory_allocated() / 1e9
    sharded = m.index
    if m.epoch != 2 or not isinstance(sharded.lists_indices,
                                      parallel.Sharded):
        fail(f"serve_dist_mutate: after the mesh rebuild epoch {m.epoch}, "
             f"lists {type(sharded.lists_indices).__name__}")
    ids = torch.cat([b.reshape(-1) for b in sharded.lists_indices.blocks])
    ids = torch.sort(ids[ids >= 0].long()).values.cpu().numpy()
    if not np.array_equal(ids, np.sort(live_ids)):
        fail("serve_dist_mutate: the rebuilt lists do not hold every live "
             "id once")
    del ids
    before = obs.snapshot()
    served_d, served, lat2, wall2 = serve_burst(srv, q_np)
    built = plan_misses(before, obs.snapshot())
    if any(built.values()):
        fail(f"serve_dist_mutate: the burst after the rebuild prepared "
             f"plans {built}")
    rebuilt_recall = dist_recall(dist_search_all(plan, q), truth_live)
    # one fold of the sharded epoch, against a fold of its lists gathered
    more = mixture_rows(n, 1024, seed, seed + 204, dev)
    more_ids = m.upsert(more)
    m.delete(up_ids[:512])
    args = []
    fold = compact_mod.fold

    def capture(*a, **kw):
        args.append((a, kw))
        return fold(*a, **kw)
    compact_mod.fold = capture
    t0 = time.perf_counter()
    try:
        if not m.compact():
            fail("serve_dist_mutate: the fold of the sharded epoch did not "
                 "run")
    finally:
        compact_mod.fold = fold
    torch.cuda.synchronize()
    sharded_fold_s = time.perf_counter() - t0
    folded_idx = m.index
    (old, rows, f_ids, tombs), kw = args[0]
    del args
    gathered = pivf.gather_index(old)
    del old
    want = compact_mod.fold(gathered, rows, f_ids, tombs, **kw)
    del gathered
    same_lists = all(torch.equal(b, w) for b, w in zip(
        folded_idx.lists_indices.blocks,
        pivf.shard_ivf_flat(want, mesh).lists_indices.blocks))
    want_s = pivf.shard_ivf_flat(want, mesh)
    fold_ids = [pivf.distributed_ivf_flat_search(
        idx_, q[:128], K, params, mesh=mesh, merge="f32")[1].cpu().numpy()
        for idx_ in (folded_idx, want_s)]
    del want, want_s
    if not same_lists or not np.array_equal(*fold_ids):
        fail("serve_dist_mutate: the sharded epoch's fold differs from a "
             "fold of its lists gathered")
    if not isinstance(folded_idx.lists_indices, parallel.Sharded) or \
            (dist_search_all(plan, more[:128])[:, 0]
             == more_ids[:128]).mean() < MUTATE_SELF_HIT:
        fail("serve_dist_mutate: the folded sharded epoch lost its layout "
             "or its rows")
    srv.close()
    phase("serve_dist_mutate_rebuild", rebuild_s=rebuild_total,
          rebuild_parts_s=rebuild_s, mem_peak_gb=rebuild_peak,
          mem_reckoned_gb=reckon_gb, epoch_rebuilt=2, epoch=m.epoch,
          lists="Sharded", max_list=int(sharded.lists_data.shape[1]),
          **latency_row(lat2, wall2),
          **{f"recall_at_{K}": rebuilt_recall},
          plans_prepared=built, sharded_fold_s=sharded_fold_s,
          sharded_fold_equals_gathered=True)
    del m, srv, plan, sharded, folded_idx, served_d, served
    mesh.close()
    free_phase("serve_dist_mutate")
    phase("serve_dist_mutate_done", seconds=time.perf_counter() - t_phase)
    return []


def parts_ms(fn, reps: int = 3) -> float:
    """Median wall milliseconds of ``fn()`` (synchronized), after one
    untimed call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def timed_build(build, mesh_parts):
    """``build()`` with each ``(owner, attribute, part)`` wrapped to add
    its synchronized seconds to the part → (result, parts, seconds,
    kernel 1's launches by shape, launches, peak GB)."""
    from raft_tpu_torch import ops
    parts = {p: 0.0 for _, _, p in mesh_parts}
    saved = [(o, a, getattr(o, a)) for o, a, _ in mesh_parts]
    for (o, a, part), (_, _, fn) in zip(mesh_parts, saved):
        def wrapped(*args, _fn=fn, _part=part, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                parts[_part] += time.perf_counter() - t0
        setattr(o, a, wrapped)
    ops.reset_launch_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = build()
        torch.cuda.synchronize()
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)
    return (out, parts, time.perf_counter() - t0, l2nn_shapes(),
            ops.launch_counts(), torch.cuda.max_memory_allocated() / 1e9)


def parts_ids_once(didx, n: int, what: str) -> None:
    ids = torch.cat([b.reshape(-1) for b in didx.parts_indices.blocks])
    ids = torch.sort(ids[ids >= 0].long()).values
    if ids.numel() != n or not torch.equal(
            ids, torch.arange(n, device=ids.device)):
        fail(f"serve_parts: the {what} parts do not hold every id once")


def parts_search(search, didx, q, params, k: int = K):
    """The queries through ``search`` in batches of 128 → (dists, ids)."""
    out = [search(didx, q[s:s + 128], k, params)
           for s in range(0, q.shape[0], 128)]
    return (torch.cat([o[0] for o in out]),
            torch.cat([o[1] for o in out]))


def run_serve_parts(x, q, q_np, truth):
    """Phase 3e (module docstring) → kernel rows."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.cluster import kmeans as kmeans_mod
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    from raft_tpu_torch.ops import select_k as sel_op
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.parallel import kmeans as pkm
    from raft_tpu_torch.tools import loadgen
    t_phase = time.perf_counter()
    n, d = x.shape
    mesh = parallel.make_mesh(devices=loadgen.dist_devices(x.device))
    n_shards = mesh.shape["data"]
    # the reckoning, before the call: ml ~2.4x a shard's mean list, the
    # parts at that width, the rows and k-means++'s n x d temporary
    mean_list = n / N_LISTS / n_shards
    ml = -(-int(2.4 * mean_list) // 8) * 8
    parts_gb = n_shards * N_LISTS * ml * d * 4 / 1e9
    rows_gb = x.numel() * 4 / 1e9
    phase("serve_parts_reckoning", mean_list=mean_list, ml=ml,
          parts_gb=parts_gb, rows_gb=rows_gb, kmeanspp_gb=rows_gb,
          peak_gb=parts_gb + 2 * rows_gb)
    wrap = [(kmeans_mod, "_plus_plus", "init"),
            (pkm, "distributed_kmeans_fit", "fit"),
            (pivf, "_label_and_widths", "label_width"),
            (pivf, "_parts_build", "label_bucket")]
    didx, bparts, build_s, shapes, launches, peak = timed_build(
        lambda: parallel.distributed_ivf_flat_build(x, ivf_flat.IndexParams(
            n_lists=N_LISTS, kmeans_n_iters=KMEANS_ITERS), mesh), wrap)
    secs = {"init": bparts["init"], "lloyd": bparts["fit"] - bparts["init"],
            "label_width": bparts["label_width"],
            "bucketing": build_s - bparts["fit"] - bparts["label_width"]}
    check_launched("serve_parts build", launches, ("fused_l2_nn",))
    parts_ids_once(didx, n, "IVF-Flat")
    ml_got = int(didx.parts_data.shape[2])
    phase("serve_parts_build", n=n, n_lists=N_LISTS, ranks=n_shards,
          build_s=build_s, parts_s=secs, ml=ml_got, ml_reckoned=ml,
          build_fused_l2_nn_shapes=shapes, build_launches=launches,
          mem_peak_gb=peak,
          parts_gb=n_shards * N_LISTS * ml_got * d * 4 / 1e9)
    params = ivf_flat.SearchParams(n_probes=N_PROBES)
    search = parallel.distributed_ivf_flat_search_parts
    from raft_tpu_torch import ops
    ops.reset_launch_counts()
    dp, ip = parts_search(search, didx, q, params)
    search_launches = ops.launch_counts()
    check_launched("serve_parts search", search_launches,
                   ("select_k", "select_k_payload"))
    recall = dist_recall(ip.cpu().numpy(), truth)
    if recall < RECALL_FLOOR:
        fail(f"serve_parts: IVF-Flat parts recall@{K} = {recall}")
    ms = {nq: parts_ms(lambda nq=nq: search(didx, q[:nq], K, params))
          for nq in (128, 8, 1)}
    # the on-card check: one index whose list l is every shard's part of
    # l side by side, searched probe-major at the same probes
    union = ivf_flat.Index(
        centers=didx.centers,
        lists_data=torch.cat([b[0] for b in didx.parts_data.blocks], 1),
        lists_indices=torch.cat([b[0] for b in didx.parts_indices.blocks],
                                1),
        lists_norms=torch.cat([b[0] for b in didx.parts_norms.blocks], 1),
        list_sizes=torch.zeros(N_LISTS, dtype=torch.int32,
                               device=x.device),
        metric=didx.metric, size=n)
    union.list_sizes = (union.lists_indices >= 0).sum(1).to(torch.int32)
    du, iu = parts_search(ivf_flat.search, union, q, ivf_flat.SearchParams(
        n_probes=N_PROBES, scan_order="probe"))
    del union
    same = (iu == ip)
    agree = float(same.float().mean())
    gap = (du - dp).abs() / du.abs().clamp(min=1.0)
    diff = torch.nonzero(~same)
    if agree < MIN_ID_AGREEMENT or float(gap.max()) > RTOL:
        fail(f"serve_parts: the parts search agrees with the union index "
             f"on {agree:.6f} of ids (floor {MIN_ID_AGREEMENT}), distances "
             f"{float(gap.max())} relative apart (1e-5)")
    phase("serve_parts", n=n, n_probes=N_PROBES, k=K,
          **{f"recall_at_{K}": recall}, search_ms=ms,
          search_launches=search_launches, union_id_agreement=agree,
          union_max_rel_gap=float(gap.max()),
          union_differing=[[int(r), int(c), float(dp[r, c]),
                            float(du[r, c])] for r, c in diff[:16].tolist()])
    rows = [check_fused_l2_nn(x[:n // n_shards],
                              didx.centers.contiguous(),
                              "fused_l2_nn@parts")]
    rows[0]["launches"] = launches["fused_l2_nn"]
    del didx, dp, ip, du, iu
    free_phase("serve_parts_flat")
    # IVF-PQ and IVF-BQ parts at the cut
    xc = x[:PROC_N]
    nc = xc.shape[0]
    phase("cut", path="serve_parts_pq_bq", n=nc,
          note="k-means++ over the rows is the multi-part build's largest "
               "serial cost (~1.2 ms a draw per million rows): 4096 draws "
               "over 10M rows would take ~50 s, so IVF-PQ and IVF-BQ parts "
               "run at fleet_procs' 2M cut; IVF-Flat parts run at 10M")
    truth_c = brute_force_knn(xc, q, K, DistanceType.L2Expanded,
                              mode="exact", device=xc.device)[1].cpu().numpy()
    pq_didx, pq_parts, pq_s, pq_shapes, pq_launches, pq_peak = timed_build(
        lambda: parallel.distributed_ivf_pq_build(xc, ivf_pq.IndexParams(
            n_lists=PQ_LISTS, pq_bits=PQ_BITS, kmeans_n_iters=KMEANS_ITERS),
            mesh), wrap[:2])
    parts_ids_once(pq_didx, nc, "IVF-PQ")
    pq_params = ivf_pq.SearchParams(n_probes=PQ_PROBES)
    pq_search = parallel.distributed_ivf_pq_search_parts
    _, pq_ip = parts_search(pq_search, pq_didx, q, pq_params)
    pq_recall = dist_recall(pq_ip.cpu().numpy(), truth_c)
    pq_ms = parts_ms(lambda: pq_search(pq_didx, q[:128], K, pq_params))
    phase("serve_parts_pq", n=nc, n_lists=PQ_LISTS, pq_dim=pq_didx.pq_dim,
          pq_bits=PQ_BITS, n_probes=PQ_PROBES, lut_dtype="bfloat16",
          build_s=pq_s, init_s=pq_parts["init"], fit_s=pq_parts["fit"],
          build_fused_l2_nn_shapes=pq_shapes, mem_peak_gb=pq_peak,
          **{f"recall_at_{K}": pq_recall}, search_ms_128=pq_ms)
    if pq_recall < RECALL_FLOOR:
        fail(f"serve_parts: IVF-PQ parts recall@{K} = {pq_recall}")
    rows.append(check_fused_l2_nn(xc[:nc // n_shards],
                                  pq_didx.centers.contiguous(),
                                  "fused_l2_nn@parts_pq"))
    rows[-1]["launches"] = pq_launches["fused_l2_nn"]
    del pq_didx, pq_ip
    bq_didx, bq_parts, bq_s, bq_shapes, bq_launches, bq_peak = timed_build(
        lambda: parallel.distributed_ivf_bq_build(xc, ivf_bq.IndexParams(
            n_lists=BQ_LISTS, kmeans_n_iters=KMEANS_ITERS, keep_raw=True),
            mesh), wrap[:2])
    parts_ids_once(bq_didx, nc, "IVF-BQ")
    bq_params = ivf_bq.SearchParams(n_probes=BQ_PROBES,
                                    rescore_factor=RESCORE,
                                    rescore_on_device="always")
    bq_search = parallel.distributed_ivf_bq_search_parts
    ops.reset_launch_counts()
    bq_d, bq_ip = parts_search(bq_search, bq_didx, q, bq_params)
    bq_search_launches = ops.launch_counts()
    bq_recall = dist_recall(bq_ip.cpu().numpy(), truth_c)
    exact = ((xc[bq_ip.long()] - q[:, None, :]) ** 2).sum(2)
    if not torch.allclose(bq_d, exact, rtol=1e-4, atol=1e-4):
        fail("serve_parts: IVF-BQ parts' rescored distances are not exact "
             "for their ids")
    bq_ms = parts_ms(lambda: bq_search(bq_didx, q[:128], K, bq_params))
    # the BQ merge's candidates: kernel 2's payload select at (128, 8 x
    # 256), k = 256, captured from one 128-query search
    cand = []
    orig = sel_op.select_k_payload

    def capture(v, ids, k, sqrt=False):
        if not cand and tuple(v.shape) == (128, n_shards * K * RESCORE):
            cand.append((v.clone(), ids.clone()))
        return orig(v, ids, k, sqrt)
    sel_op.select_k_payload = capture
    try:
        bq_search(bq_didx, q[:128], K, bq_params)
        torch.cuda.synchronize()
    finally:
        sel_op.select_k_payload = orig
    if not cand:
        fail("serve_parts: no IVF-BQ merge rows captured")
    phase("serve_parts_bq", n=nc, n_lists=BQ_LISTS, n_probes=BQ_PROBES,
          rescore_factor=RESCORE, rescored_on_device=True, build_s=bq_s,
          init_s=bq_parts["init"], fit_s=bq_parts["fit"],
          build_fused_l2_nn_shapes=bq_shapes, mem_peak_gb=bq_peak,
          **{f"recall_at_{K}": bq_recall}, rescored_exact=True,
          search_ms_128=bq_ms, search_launches=bq_search_launches)
    if bq_recall < RECALL_FLOOR:
        fail(f"serve_parts: IVF-BQ parts recall@{K} = {bq_recall}")
    rows.append(check_fused_l2_nn(xc[:nc // n_shards],
                                  bq_didx.centers.contiguous(),
                                  "fused_l2_nn@parts_bq"))
    rows[-1]["launches"] = bq_launches["fused_l2_nn"]
    rows.append(check_pass_b("select_k_payload@parts_bq", *cand[0],
                             K * RESCORE,
                             bq_search_launches["select_k_payload"],
                             "raft_tpu/ops/pallas_select_k.py:47"))
    del bq_didx, bq_d, bq_ip, exact, cand, xc
    mesh.close()
    free_phase("serve_parts")
    phase("serve_parts_done", seconds=time.perf_counter() - t_phase)
    return rows


def run_flat_narrow(x, q, q_np, truth, args, storage: str):
    """Phases 3b, 3c: IVF-Flat at ``storage`` (bfloat16: built on every
    row; int8: built on the first rows, then ``extend``-ed with the last
    1/EXTEND_SHARE, ids continuing), served as phase 3, then its k=512
    search; both scans against their plain versions afterwards. Returns
    the rows, each with its kernel's launches over this path's run."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    tag = FLAT_STORAGES[storage]
    n = x.shape[0]
    params = ivf_flat.IndexParams(n_lists=N_LISTS,
                                  kmeans_n_iters=KMEANS_ITERS,
                                  storage_dtype=storage)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grown = {}
    if storage == "int8":
        n0 = n - n // EXTEND_SHARE
        index = ivf_flat.build(x[:n0], params)
        torch.cuda.synchronize()
        scale0, t1 = index.scale, time.perf_counter()
        index = ivf_flat.extend(index, x[n0:])
        torch.cuda.synchronize()
        ids = index.lists_indices[index.lists_indices >= 0]
        if ids.numel() != n or int(ids.min()) != 0 or int(ids.max()) != n - 1:
            fail(f"IVF-Flat int8 extend: {ids.numel()} ids, not 0..{n - 1}")
        grown = dict(built_rows=n0, extended_rows=n - n0, extend_s=
                     time.perf_counter() - t1, scale_before=scale0,
                     scale_after=index.scale)
        del ids
    else:
        index = ivf_flat.build(x, params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if index.lists_data.dtype != getattr(torch, storage) or index.size != n:
        fail(f"IVF-Flat {storage}: lists of {index.lists_data.dtype}, "
             f"size {index.size}")
    build_launches = ops.launch_counts()
    ladder_s, served, burst = serve_flat(index, q_np, truth, n,
                                         f"flat_{tag}" if args.profile
                                         else "")
    launches = ops.launch_counts()
    check_launched(f"IVF-Flat {storage}", launches,
                   ("fused_l2_nn", "select_k", f"ivf_scan_{tag}"))
    if launches["ivf_scan"] or launches["ivf_list_scan"]:
        fail(f"IVF-Flat {storage}: the f32 row policy was launched")
    phase(f"main_flat_{tag}", n=n, dim=D, n_lists=N_LISTS,
          storage_dtype=storage, scale=index.scale, **grown,
          max_list=int(index.lists_data.shape[1]), build_s=build_s,
          ladder_s=ladder_s, **served, build_launches=build_launches,
          burst_launches=burst, launches=launches,
          index_gb=(index.lists_data.numel()
                    * index.lists_data.element_size()) / 1e9,
          mem_allocated_gb=torch.cuda.memory_allocated() / 1e9,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    wide_launches = run_wide_flat(index, q, truth, tag)
    fused, wide, _ = check_flat_scans(index, q, tag)
    fused["launches"] = launches[f"ivf_scan_{tag}"]
    wide["launches"] = wide_launches[f"ivf_list_scan_{tag}"]
    del index
    free_phase(f"flat_{tag}")
    return [fused, wide]


def run_wide_flat(index, q, truth, tag: str = ""):
    """The k > 256 route: one list-major search of 128 queries at
    k=FLAT_WIDE_K through the unfused list scan (at the storage ``tag``
    names, "" for f32) and the merge."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors import ivf_flat
    params = ivf_flat.SearchParams(n_probes=N_PROBES, scan_order="list")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    d_w, i_w = ivf_flat.search(index, q[:128], FLAT_WIDE_K, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_launched("wide IVF-Flat", launches,
                   ("select_k", "ivf_list_scan" + (f"_{tag}" if tag else "")))
    i_w = i_w.cpu().numpy()
    if i_w.shape != (128, FLAT_WIDE_K) or (i_w < 0).any() or \
            not bool(torch.isfinite(d_w).all()) or \
            bool((torch.diff(d_w, dim=1) < 0).any()):
        fail("the k=512 IVF-Flat search returned missing or unsorted "
             "neighbours")
    recall = float(np.mean([len(set(i_w[r][:K]) & set(truth[r]))
                            for r in range(128)])) / K
    if recall < RECALL_FLOOR:
        fail(f"wide IVF-Flat recall@{K} of the top {K} = {recall}")
    phase("wide_flat", storage=tag or "f32", nq=128, k=FLAT_WIDE_K,
          n_probes=N_PROBES, order="list", search_s=wall,
          **{f"recall_at_{K}_of_top_{K}": recall}, launches=launches,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def free_phase(path: str) -> None:
    """After the caller's ``del`` of an index: device memory then and
    after a collection pass (what the pass frees, reference cycles
    held)."""
    after_del = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    phase("free", path=path, allocated_gb_after_del=after_del / 1e9,
          allocated_gb_after_gc=torch.cuda.memory_allocated() / 1e9)


def run_family(fam: Family, x, q, q_np, truth, args, beside=None):
    """Phases 4 and 5, and their grown forms: ``fam``'s build (for a
    ``grow`` point on the first 1 - 1/EXTEND_SHARE of the rows, then
    ``extend`` with the rest) + serving + one k=WIDE_K search; the scans
    named by ``fam.rows``, and the path's k-means and coarse shapes,
    checked against their plain versions on the served index; then the
    index is dropped. ``beside``: fields printed with the phase (the
    point's recall before it grew). Returns (rows, launches, the served
    recall)."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.serve import SearchServer, ServeConfig
    mod = importlib.import_module(f"raft_tpu_torch.neighbors.{fam.module}")
    params = mod.SearchParams(n_probes=fam.n_probes, rescore_factor=RESCORE,
                              rescore_on_device="always")
    index_params = mod.IndexParams(
        n_lists=fam.n_lists, kmeans_n_iters=KMEANS_ITERS, keep_raw=True,
        **fam.index_params)
    n = x.shape[0]
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grown = {}
    if fam.grow:
        n0 = n - n // EXTEND_SHARE
        index = mod.build(x[:n0], index_params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        built = ops.launch_counts()
        index = mod.extend(index, x[n0:])
        torch.cuda.synchronize()
        after = ops.launch_counts()
        ids = index.lists_indices[index.lists_indices >= 0]
        if ids.numel() != n or int(ids.min()) != 0 or int(ids.max()) != n - 1 \
                or index.size != n or index.raw.shape[0] != n:
            fail(f"{fam.label} extend: {ids.numel()} ids, not 0..{n - 1}")
        grown = dict(built_rows=n0, extended_rows=n - n0,
                     build_only_s=t1 - t0, extend_s=time.perf_counter() - t1,
                     extend_launches={k_: after[k_] - built[k_]
                                      for k_ in after if after[k_] - built[k_]})
        del ids
    else:
        index = mod.build(x, index_params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    build_shapes = l2nn_shapes()
    t0 = time.perf_counter()
    srv = SearchServer.from_index(
        index, q_np[:128], K, params=params,
        config=ServeConfig(batch_sizes=BATCH_SIZES, max_queue=512,
                           max_wait_ms=2.0))
    ladder_s = time.perf_counter() - t0
    pre_burst = ops.launch_counts()
    served = serve_phase(srv, q_np, truth, n, fam.tag if args.profile else "")
    pre_wide = ops.launch_counts()
    d_w, i_w = mod.search(index, q[:128], WIDE_K, params)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    fused = fam.op + "_fused"
    check_launched(fam.label, launches, ("fused_l2_nn", "select_k", fam.op,
                                         fused))
    n_batches = sum(v for k_, v in served["batches"].items()
                    if k_.startswith("raft.serve.batch.total"))
    if pre_wide[fused] - pre_burst[fused] < n_batches:
        fail(f"{fam.label}: {pre_wide[fused] - pre_burst[fused]} fused-scan "
             f"launches for {n_batches} served batches")
    i_w = i_w.cpu().numpy()
    if i_w.shape != (128, WIDE_K) or (i_w < 0).any() or \
            not bool(torch.isfinite(d_w).all()):
        fail(f"the k={WIDE_K} {fam.label} search returned missing neighbours")
    wide_recall = float(np.mean([len(set(i_w[r][:K]) & set(truth[r]))
                                 for r in range(128)])) / K
    if wide_recall < RECALL_FLOOR:
        fail(f"the k={WIDE_K} {fam.label} search: recall@{K} of the top "
             f"{K} = {wide_recall}")
    phase(f"main_{fam.tag}", n=n, dim=D, n_lists=fam.n_lists,
          **fam.fields(index), n_probes=fam.n_probes, rescore_factor=RESCORE,
          **grown, max_list=int(index.lists_indices.shape[1]),
          build_s=build_s, ladder_s=ladder_s, **served, **(beside or {}),
          served_batches=n_batches,
          wide_k=WIDE_K, **{f"wide_recall_at_{K}_of_top_{K}": wide_recall},
          build_launches=build_launches,
          build_fused_l2_nn_shapes=build_shapes,
          burst_launches={k_: pre_wide[k_] - pre_burst[k_] for k_ in launches},
          wide_launches={k_: launches[k_] - pre_wide[k_] for k_ in launches},
          launches=launches,
          mem_allocated_gb=torch.cuda.memory_allocated() / 1e9,
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    f32_launches = run_pq_f32(mod, index, q, params) if fam.f32_tier else {}
    if fam.scan_modes:
        run_scan_modes(mod, index, q, truth, params, args.profile)
    centers = index.centers.contiguous()
    rows = (check_family_scans(fam, index, q, params, launches, f32_launches)
            if fam.rows != "none" else [])
    if fam.rows == "all" and fam.n_lists != N_LISTS:
        # fused L2-NN at this path's shapes: the sampled rows (the sweeps)
        # and every row (the build's predict) against its n_lists centres
        rows.append(check_fused_l2_nn(sample_rows(x, KM_ROWS, 13), centers,
                                      f"fused_l2_nn@{fam.module}"))
        rows.append(check_fused_l2_nn(x, centers,
                                      f"fused_l2_nn@{fam.module}_predict"))
    if fam.rows == "all":
        # select-k at this path's coarse shape: n_probes of n_lists scores
        rows.append(check_select_k(q, centers, fam.n_probes,
                                   f"select_k@{fam.module}"))
    del index, srv, centers
    free_phase(fam.tag)
    return rows, launches, served[f"recall_at_{K}"]


def run_scan_modes(mod, index, q, truth, params, profile: bool):
    """IVF-PQ's torch-op scans through the entry point: one 128-query
    search at ``scan_mode="reconstruct"`` (list-major, the first call
    filling the bf16 decode cache) and one at ``"lut"``, each at k=K with
    the served point's re-rank; recall@K, the first and a second call's
    seconds, the cache's device memory and the launches. ``profile``:
    trace a third reconstruct search (``profile_pq_reconstruct.txt``)."""
    from raft_tpu_torch import ops
    for mode in ("reconstruct", "lut"):
        prm = dataclasses.replace(params, scan_mode=mode,
                                  scan_order="list")
        mem0 = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        d, i = mod.search(index, q[:128], K, prm)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        cache_b = (index.decoded.numel() * index.decoded.element_size()
                   if index.decoded is not None else 0)
        t0 = time.perf_counter()
        mod.search(index, q[:128], K, prm)
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
        if profile and mode == "reconstruct":
            def wall_s():
                t0 = time.perf_counter()
                mod.search(index, q[:128], K, prm)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            profile_run(wall_s, "pq_reconstruct", "profile_pq_reconstruct")
        i = i.cpu().numpy()
        if i.shape != (128, K) or (i < 0).any() or \
                not bool(torch.isfinite(d).all()):
            fail(f"IVF-PQ {mode}: missing neighbours")
        recall = float(np.mean([len(set(i[r]) & set(truth[r]))
                                for r in range(128)])) / K
        if recall < RECALL_FLOOR:
            fail(f"IVF-PQ {mode}: recall@{K} = {recall} < {RECALL_FLOOR}")
        phase("pq_scan_modes", mode=mode, nq=128, k=K,
              n_probes=params.n_probes, rescore_factor=RESCORE,
              order="list" if mode == "reconstruct" else "probe",
              **{f"recall_at_{K}": recall}, first_s=first_s, again_s=again_s,
              again_ms_per_query=again_s * 1e3 / 128,
              decode_cache_gb=cache_b / 1e9,
              mem_added_gb=(torch.cuda.memory_allocated() - mem0) / 1e9,
              launches={k_: v for k_, v in launches.items() if v})
    index.decoded = index.decoded_norms = None


def run_two_level(x):
    """Phase 5d: ``build_hierarchical`` at TWO_LEVEL_LISTS centres over
    the dataset (the two-level path: isqrt(k) mesoclusters, fine centres
    in each, two balancing sweeps over all), then the predict of every
    row; seconds, kernel 1's launches by shape, list sizes and the mean
    squared distance to the assigned centre."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster.kmeans_balanced import build_hierarchical
    from raft_tpu_torch.distance import fused_l2_nn
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    centers = build_hierarchical(x, TWO_LEVEL_LISTS, KMEANS_ITERS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_shapes = l2nn_shapes()
    launches = ops.launch_counts()
    check_launched("two-level k-means", launches, ("fused_l2_nn",))
    if tuple(centers.shape) != (TWO_LEVEL_LISTS, D) or \
            not bool(torch.isfinite(centers).all()):
        fail(f"two-level k-means: centres of shape {tuple(centers.shape)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kv = fused_l2_nn(x, centers)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    sizes = torch.bincount(kv.key.long(), minlength=TWO_LEVEL_LISTS)
    phase("kmeans_two_level", n=x.shape[0], dim=D,
          n_clusters=TWO_LEVEL_LISTS, sweeps=KMEANS_ITERS, train_s=train_s,
          predict_s=predict_s, fused_l2_nn_shapes=train_shapes,
          distinct_shapes=len(train_shapes),
          predict_fused_l2_nn_shapes=l2nn_shapes(),
          list_size_max=int(sizes.max()),
          list_size_mean=float(sizes.float().mean()),
          empty_lists=int((sizes == 0).sum()),
          mean_sq_dist=float(kv.value.double().mean()),
          launches={k_: v for k_, v in launches.items() if v},
          mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del centers, kv, sizes


def cuda_once(fn):
    """``(fn(), device milliseconds of that one call)``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def recall_at(ids: torch.Tensor, truth: torch.Tensor) -> float:
    """Mean share of each row's ``truth`` ids that ``ids`` holds."""
    ids, truth = ids.cpu().numpy(), truth.cpu().numpy()
    return float(np.mean([len(set(a) & set(b))
                          for a, b in zip(ids, truth)])) / truth.shape[1]


def check_knn_result(what: str, d, i, n: int, descending: bool) -> None:
    """(BF_QUERIES, K) neighbours, ids in range, finite sorted values."""
    if tuple(i.shape) != (d.shape[0], K) or bool((i < 0).any()) \
            or bool((i >= n).any()) or not bool(torch.isfinite(d).all()):
        fail(f"{what}: missing, out-of-range or non-finite neighbours")
    step = torch.diff(d, dim=1)
    if bool(((step > 0) if descending else (step < 0)).any()):
        fail(f"{what}: neighbours are not sorted")


def check_fused_knn(name, xq, y, metric, replaces, launches, precision,
                    src="raft_tpu_torch/csrc/fused_knn.cu", bound_as=None):
    """The fused k-NN kernel (both passes) at ``precision`` against its
    plain version at the same arithmetic on the main path's inputs, within
    ``RTOL`` of |x|^2 + |y|^2; the plain version is timed on its one
    call. The bound counts the products at ``bound_as`` (default
    ``precision``)."""
    from raft_tpu_torch.ops import fused_knn as op
    m, dim = xq.shape
    n = y.shape[0]
    _, tn, l_bins, kt = op.geometry(m, n, dim, K)
    saved = (op.launches, op.launches_f32, op.launches_ktiled,
             op.launches_ktiled_f32)
    kernel = lambda: op.fused_knn_cuda(xq, y, K, metric, False, tn,  # noqa: E731
                                       l_bins, kt, precision)
    d_k, i_k = kernel()
    (d_p, i_p), plain_ms = cuda_once(lambda: op.fused_knn_plain(
        xq, y, K, metric, False, tn, l_bins, kt, precision))
    scale = (xq * xq).sum(1)[:, None] + (y * y).sum(1)[i_p.clamp(min=0).long()]
    max_abs, agree = compare(name, d_k, i_k, d_p, i_p, False, scale)
    del d_k, i_k, d_p, i_p
    ms = cuda_ms(kernel, BF_REPS, warmup=1)
    (op.launches, op.launches_f32, op.launches_ktiled,
     op.launches_ktiled_f32) = saved
    # the products at the arithmetic asked for: bf16x3 (the TPU kernel's)
    # three bf16 passes on the tensor cores, f32 one pass on the CUDA cores
    ops = 2 * m * n * dim
    bnd = bound(4 * (m + n) * dim + 8 * m * K,
                {"bf16x3": (3 * ops, BF16_FLOPS), "bf16": (ops, BF16_FLOPS),
                 "f32": (ops, FP32_FLOPS)}[bound_as or precision])
    prod = product_ms(xq, y) if precision == "f32" else None
    phase("kernels", kernel=name, shape=[m, n, dim], k=K, tn=tn,
          l_bins=l_bins, kt=kt, precision=precision, id_agreement=agree,
          max_abs_err=max_abs,
          ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
          f32_cuda_core_ms=2 * m * n * dim / FP32_FLOPS * 1e3,
          product_ms=prod)
    row = kernel_row(name, src, replaces, max_abs, ms, plain_ms, bnd, None)
    if prod is not None:
        row["product_ms"] = prod
    row["launches"] = launches
    return row


def run_bf(x, qb, args):
    """Phase 6: fused brute-force k-NN of BF_QUERIES queries over the
    dataset for three metrics at the card's default precision (bf16x3 on
    the tensor cores), and L2 at ``"highest"`` (kernel 5's f32 body), each
    against the exact scan, and kernel 5 against its plain version at the
    same arithmetic on each run's kernel inputs."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    from raft_tpu_torch.neighbors.processing import preprocess_rows
    m, n = qb.shape[0], x.shape[0]
    rows = []
    exact_l2 = None
    for metric, kmetric, label, prec in (
            (DistanceType.L2Expanded, "l2", "l2", None),
            (DistanceType.InnerProduct, "ip", "ip", None),
            (DistanceType.CosineExpanded, "ip", "cosine", None),
            (DistanceType.L2Expanded, "l2", "highest", "highest")):
        def fused(metric=metric, prec=prec):
            return brute_force_knn(x, qb, K, metric, mode="fused",
                                   kernel_precision=prec)
        key = "fused_knn_f32" if prec == "highest" else "fused_knn"
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        d_f, i_f = fused()
        ms = cuda_ms(fused, BF_REPS, warmup=0)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_launched(f"brute force {label}", launches, (key,))
        check_knn_result(f"fused {label}", d_f, i_f, n, label == "ip")
        exact_ms = None
        if exact_l2 is not None and kmetric == "l2":
            i_e = exact_l2  # the same function: L2's exact scan
        else:
            (d_e, i_e), exact_ms = cuda_once(
                lambda: brute_force_knn(x, qb, K, metric, mode="exact"))
            check_knn_result(f"exact {label}", d_e, i_e, n, label == "ip")
            del d_e
            if kmetric == "l2":
                exact_l2 = i_e
        recall = recall_at(i_f, i_e)
        floor = BF_RECALL_GATE if kmetric == "l2" else RECALL_FLOOR
        if recall < floor:
            fail(f"fused {label}: recall@{K} {recall} < {floor}")
        phase("main_bf", metric=label, precision=prec or "bf16x3", n=n,
              dim=D, nq=m, k=K, ms=ms, qps=m / (ms / 1e3),
              **{f"recall_at_{K}": recall}, exact_ms=exact_ms,
              exact_qps=m / (exact_ms / 1e3) if exact_ms else None,
              mem_peak_gb=peak / 1e9, launches=launches)
        if args.profile and label == "l2":
            def wall_s(fused=fused):
                t0 = time.perf_counter()
                fused()
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            profile_run(wall_s, "bf", "profile_bf")
        del d_f, i_f, i_e
        if label == "cosine":
            xq, y = preprocess_rows(qb, metric), preprocess_rows(x, metric)
        else:
            xq, y = qb, x
        rows.append(check_fused_knn(
            "fused_knn" if label == "l2" else f"fused_knn@{label}", xq, y,
            kmetric, "raft_tpu/ops/pallas_fused_knn.py:100", launches[key],
            "f32" if prec == "highest" else "bf16x3",
            "raft_tpu_torch/csrc/fused_knn.cu" if prec == "highest"
            else "raft_tpu_torch/csrc/fused_knn_tc.cu"))
        if label == "l2":
            # pass B alone on kernel 5's candidate rows (pass A's plain
            # version at the kernel's bf16x3, the same bins)
            from raft_tpu_torch.ops import fused_knn as kop
            _, tn, l_bins, kt = kop.geometry(m, n, D, K)
            cand = kop.bin_candidates_plain(qb, x, "l2", tn, l_bins, kt,
                                            "bf16x3")
            rows.append(check_pass_b("select_k_payload@bf", *cand, K,
                                     launches[key],
                                     "raft_tpu/ops/pallas_fused_knn.py:100"))
            del cand
        del xq, y
    return rows


def run_wide_bf(seed: int, dev):
    """Phase 7: the d > 4096 route (kernel 6) on WIDE_N x WIDE_D normal
    rows, BF_QUERIES queries, at the card's default bf16x3 (the
    tensor-core pass A) and at ``"highest"`` (its f32 body), each against
    the exact scan (recall gate BF_RECALL_GATE) and its plain version at
    the same arithmetic."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    y = torch.randn((WIDE_N, WIDE_D), generator=g, device=dev)
    qw = torch.randn((BF_QUERIES, WIDE_D), generator=g, device=dev)
    (_, i_e), exact_ms = cuda_once(lambda: brute_force_knn(
        y, qw, K, DistanceType.L2Expanded, mode="exact"))
    rows = []
    for prec, key, tag, src in (
            (None, "fused_knn_ktiled", "", "fused_knn_tc.cu"),
            ("highest", "fused_knn_ktiled_f32", "@highest", "fused_knn.cu")):
        def fused(prec=prec):
            return brute_force_knn(y, qw, K, DistanceType.L2Expanded,
                                   mode="fused", kernel_precision=prec)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        d_f, i_f = fused()
        ms = cuda_ms(fused, BF_REPS, warmup=0)
        launches = ops.launch_counts()
        check_launched(f"wide brute force{tag}", launches, (key,))
        check_knn_result(f"wide fused{tag}", d_f, i_f, WIDE_N, False)
        recall = recall_at(i_f, i_e)
        if recall < BF_RECALL_GATE:
            fail(f"wide fused{tag}: recall@{K} {recall} < {BF_RECALL_GATE}")
        precision = "f32" if prec else "bf16x3"
        phase("wide_bf", precision=prec or "bf16x3", n=WIDE_N, dim=WIDE_D,
              nq=BF_QUERIES, k=K, ms=ms, qps=BF_QUERIES / (ms / 1e3),
              **{f"recall_at_{K}": recall}, exact_ms=exact_ms,
              launches={k_: v for k_, v in launches.items() if v},
              mem_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del d_f, i_f
        rows.append(check_fused_knn(
            "fused_knn_ktiled" + tag, qw, y, "l2",
            "raft_tpu/ops/pallas_fused_knn.py:121", launches[key], precision,
            "raft_tpu_torch/csrc/" + src))
    return rows


def pair_row(name, tag, sqrt, p_lib, xa, ya, p: float = 3.0):
    """One ``elementwise_dist@<name>`` row: ``pairwise_distance`` of the
    metric ``tag`` names at exponent ``p`` (launches counted), the kernel
    against its plain version (hamming exactly) and, where ``p_lib`` is
    not None, one ``torch.cdist`` call as the library time."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.ops import elementwise_dist as op
    metric = PAIR_ENTRY.get(name, name)
    m, dim = xa.shape
    n = ya.shape[0]

    def entry():
        return pairwise_distance(xa, ya, metric, p=p)

    def kernel():
        return op.elementwise_dist_cuda(xa, ya, tag, p, sqrt)
    ops.reset_launch_counts()
    out = entry()
    entry_ms = cuda_ms(entry, 3, warmup=0)
    launches = ops.launch_counts()["elementwise_dist"]
    if launches < 4:
        fail(f"pairwise {name}: {launches} elementwise_dist launches")
    saved = op.launches
    d_k = kernel()
    d_p, plain_ms = cuda_once(lambda: op.elementwise_dist_plain(
        xa, ya, tag, p, sqrt))
    fin = torch.isfinite(d_p)
    err = torch.where(fin, d_k - d_p, torch.zeros_like(d_k)).abs()
    max_abs = float(err.max())
    exact = name == "hamming" or p == 0.0
    if not torch.equal(torch.isfinite(d_k), fin) or not torch.equal(out, d_k) \
            or (exact and not torch.equal(d_k, d_p)) \
            or bool((err > ELT_ATOL + ELT_RTOL * d_p.abs()).any()):
        fail(f"pairwise {name}: kernel differs from its plain version "
             f"by up to {max_abs}")
    del out, d_p, err, fin
    ms = cuda_ms(kernel, 5)
    op.launches = saved
    lib_ms = lib_err = None
    if p_lib is not None:
        def lib():
            return torch.cdist(xa, ya, p=p_lib,
                               compute_mode="donot_use_mm_for_euclid_dist")
        d_l = lib()
        if p_lib == 0.0:  # the count, timed alone; hamming divides
            d_l = d_l / dim
        lib_err = float((d_l - d_k).abs().max())
        del d_l
        lib_ms = cuda_ms(lib, 5)
    del d_k
    fp, sfu = ELT_WORK[tag]
    elems = m * n * dim
    bnd = bound(4 * (m + n) * dim + 4 * m * n, (fp * elems, FP32_INSTR),
                (sfu * elems, SFU_OPS))
    phase("pairwise", metric=name, core=tag, sqrt=sqrt, p=p,
          shape=[m, n, dim], entry_ms=entry_ms, ms=ms,
          plain_ms=plain_ms, library_ms=lib_ms,
          library_max_abs_err=lib_err, max_abs_err=max_abs,
          bound_ms=bnd[0], bound_by=bnd[1], launches=launches)
    row = kernel_row(f"elementwise_dist@{name}",
                     "raft_tpu_torch/csrc/elementwise_dist.cu",
                     "raft_tpu/ops/pallas_elementwise_dist.py:49",
                     max_abs, ms, plain_ms, bnd, lib_ms)
    row["launches"] = launches
    return row


def run_pairwise(x1m, q100, seed: int, dev):
    """Phase 8: every elementwise metric name through ``pairwise_distance``
    at PAIR_N x PAIR_N x PAIR_D (kernel 7), each against its plain version
    and, where one computes the same function, ``torch.cdist``; canberra
    on data whose |a| + |b| lies in (2^126, 2^128) and minkowski at p = 0
    (rows ``@canberra_big``, ``@minkowski_p0``); the expanded metrics'
    times; one exact L1 scan through kernel 7."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    a = torch.rand((PAIR_N, PAIR_D), generator=g, device=dev)
    b = torch.rand((PAIR_N, PAIR_D), generator=g, device=dev)
    ai, bi = torch.floor(a * 4), torch.floor(b * 4)  # {0, 1, 2, 3}
    rows = []
    for name, (tag, sqrt, p_lib) in PAIR_NAMES.items():
        xa, ya = (ai, bi) if name == "hamming" else (a, b)
        rows.append(pair_row(name, tag, sqrt, p_lib, xa, ya))
    # |a|, |b| in [2^125, 2^126) with random signs: |a| + |b| in
    # [2^126, 2^127), where a lone __fdividef would return 0
    sign = torch.where(b < 0.5, -1.0, 1.0)
    big_a, big_b = (1.0 + a) * 2.0 ** 125 * sign, (1.0 + b) * 2.0 ** 125
    rows.append(pair_row("canberra_big", "canberra", False, None, big_a,
                         big_b))
    del big_a, big_b, sign
    rows.append(pair_row("minkowski_p0", "minkowski", False, None, a, b,
                         p=0.0))
    expanded = {name: cuda_ms(lambda name=name: pairwise_distance(a, b, name),
                              3) for name in PAIR_EXPANDED}
    # kernel 7 inside the exact scan: L1 k-NN of 100 queries over 1M rows
    ops.reset_launch_counts()
    (d1, i1), l1_ms = cuda_once(lambda: brute_force_knn(
        x1m, q100, K, DistanceType.L1))
    launches = ops.launch_counts()
    check_launched("exact L1 scan", launches, ("elementwise_dist",))
    d_ref, i_ref = torch.topk(torch.cdist(q100, x1m, p=1.0), K, dim=1,
                              largest=False)
    agree = float((i1.long() == i_ref).double().mean())
    if agree < MIN_ID_AGREEMENT or bool(
            ((d1 - d_ref).abs() > ELT_ATOL + ELT_RTOL * d_ref).any()):
        fail(f"exact L1 scan: ids agree on {agree} with torch.cdist + topk")
    phase("pairwise", expanded_ms=expanded, l1_scan={
        "n": x1m.shape[0], "nq": q100.shape[0], "k": K, "ms": l1_ms,
        "id_agreement_vs_cdist": agree, "launches": launches})
    return rows


def elt_row(name, tag, xa, ya, launches, p_lib=None):
    """Kernel 7 at one path's shape, ``(xa, ya)`` under core ``tag``,
    against its plain version (``ELT_ATOL + ELT_RTOL * |plain|``), with
    ``torch.cdist`` at ``p_lib`` as the library time where it computes
    the same function; ``launches`` are the path's."""
    from raft_tpu_torch.ops import elementwise_dist as op
    m, dim = xa.shape
    n = ya.shape[0]
    saved = op.launches
    kernel = lambda: op.elementwise_dist_cuda(xa, ya, tag)  # noqa: E731
    d_k = kernel()
    d_p, plain_ms = cuda_once(lambda: op.elementwise_dist_plain(xa, ya,
                                                                tag))
    err = (d_k - d_p).abs()
    max_abs = float(err.max())
    if bool((err > ELT_ATOL + ELT_RTOL * d_p.abs()).any()):
        fail(f"{name}: kernel differs from its plain version by up to "
             f"{max_abs}")
    del d_k, d_p, err
    ms = cuda_ms(kernel, 3)
    op.launches = saved
    lib_ms = None
    if p_lib is not None:
        lib_ms = cuda_ms(lambda: torch.cdist(
            xa, ya, p=p_lib, compute_mode="donot_use_mm_for_euclid_dist"), 3)
    fp, sfu = ELT_WORK[tag]
    elems = m * n * dim
    bnd = bound(4 * (m + n) * dim + 4 * m * n, (fp * elems, FP32_INSTR),
                (sfu * elems, SFU_OPS))
    phase("kernels", kernel=name, core=tag, shape=[m, n, dim],
          max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bnd[0], bound_by=bnd[1], launches=launches)
    row = kernel_row(name, "raft_tpu_torch/csrc/elementwise_dist.cu",
                     "raft_tpu/ops/pallas_elementwise_dist.py:49",
                     max_abs, ms, plain_ms, bnd, lib_ms)
    row["launches"] = launches
    return row


def run_kmeans_fit(xk):
    """Phase 9a: ``kmeans.fit`` at KM_FIT_CLUSTERS centres, Random then
    k-means++ init; each fit's seconds, iterations, inertia and kernel
    1's launches by shape; a second fit at one seed bit for bit; the
    inertia against ``cluster_cost`` of the centres. Returns the Random
    fit's centres, the kernel 1 row and the launches of both fits."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    total, kept = 0, None
    for init in (InitMethod.Random, InitMethod.KMeansPlusPlus):
        params = KMeansParams(n_clusters=KM_FIT_CLUSTERS, init=init,
                              max_iter=KM_FIT_ITERS, seed=7, n_init=1)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        centers, inertia, n_iter = kmeans.fit(xk, params)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        shapes = l2nn_shapes()
        launches = ops.launch_counts()
        check_launched(f"kmeans.fit {init.name}", launches, ("fused_l2_nn",))
        total += launches["fused_l2_nn"]
        again = kmeans.fit(xk, params)
        repeat = bool(torch.equal(again[0], centers)
                      and torch.equal(again[1], inertia))
        cost = float(kmeans.cluster_cost(xk, centers))
        rel = abs(float(inertia) - cost) / cost
        phase("cluster", part="kmeans.fit", init=init.name,
              rows=xk.shape[0], n_clusters=KM_FIT_CLUSTERS,
              max_iter=KM_FIT_ITERS, seconds=fit_s, n_iter=n_iter,
              inertia=float(inertia), cluster_cost=cost,
              inertia_vs_cost_rel=rel, repeat_bit_identical=repeat,
              fused_l2_nn_shapes=shapes,
              launches={k_: v for k_, v in launches.items() if v})
        if not repeat:
            fail(f"kmeans.fit {init.name}: two fits at one seed differ")
        if rel > 1e-3 or not bool(torch.isfinite(centers).all()):
            fail(f"kmeans.fit {init.name}: inertia {float(inertia)} vs "
                 f"cluster_cost {cost}")
        if kept is None:
            kept = centers
    row = check_fused_l2_nn(xk, kept, "fused_l2_nn@kmeans")
    row["launches"] = total
    return kept, row


def run_single_linkage(x):
    """Phase 9b: ``single_linkage`` over the kNN graph of SL_ROWS rows
    (its parts' seconds and the components before each connectivity
    round; a valid dendrogram: n - 1 merges of rising height ending at
    size n, SL_CLUSTERS labels), then PAIRWISE on SL_PAIR_ROWS rows
    against ``scipy.cluster.hierarchy.linkage(method="single")``."""
    import importlib
    from scipy.cluster.hierarchy import cut_tree, linkage
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster import LinkageDistance, single_linkage
    sl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")
    for route, n in (("KNN_GRAPH", SL_ROWS), ("PAIRWISE", SL_PAIR_ROWS)):
        xs = x[:n].contiguous()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        labels, children = single_linkage(xs, SL_CLUSTERS,
                                          LinkageDistance[route], SL_C)
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        run = dict(sl.last_run)
        heights = run.pop("heights")
        ch = children.cpu().numpy()
        size = np.ones(2 * n - 1, np.int64)
        for e, (a, b) in enumerate(ch):
            size[n + e] = size[a] + size[b]
        lab = labels.cpu().numpy()
        valid = (ch.shape == (n - 1, 2) and bool(np.all(np.diff(heights)
                                                        >= 0))
                 and int(size[-1]) == n
                 and len(np.unique(lab)) == SL_CLUSTERS)
        fields = {}
        if route == "PAIRWISE":
            t1 = time.perf_counter()
            z = linkage(xs.cpu().double().numpy(), method="single")
            ref = cut_tree(z, n_clusters=SL_CLUSTERS).reshape(-1)
            fields = {"scipy_s": time.perf_counter() - t1,
                      "heights_max_rel_err": float(np.max(np.abs(
                          np.sort(z[:, 2]) - heights)
                          / np.maximum(np.sort(z[:, 2]), 1e-30))),
                      "label_pairs": len(set(zip(lab.tolist(),
                                                 ref.tolist())))}
        phase("cluster", part="single_linkage", route=route, rows=n,
              c=SL_C, n_clusters=SL_CLUSTERS, seconds=seconds,
              dendrogram_valid=valid, **run, **fields,
              launches={k_: v for k_, v in launches.items() if v})
        if not valid:
            fail(f"single_linkage {route}: invalid dendrogram")
        if route == "PAIRWISE" and (fields["heights_max_rel_err"] > 1e-4
                                    or fields["label_pairs"] != SL_CLUSTERS):
            fail(f"single_linkage PAIRWISE: differs from scipy {fields}")
        del labels, children, xs


def run_silhouette(x, centers):
    """Phase 9c: ``silhouette_score`` of SIL_ROWS rows at the fit's
    labels, euclidean and cityblock, each held to the port's CPU run on
    SIL_SUB of them; the cityblock run's tiles make the kernel 7 row."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.stats import silhouette_score
    xs = x[:SIL_ROWS].contiguous()
    labels = kmeans.predict(xs, centers)
    row = None
    for metric in ("euclidean", "cityblock"):
        ops.reset_launch_counts()
        score, ms = cuda_once(lambda: silhouette_score(xs, labels,
                                                       metric=metric))
        launches = ops.launch_counts()
        sub = float(silhouette_score(xs[:SIL_SUB], labels[:SIL_SUB],
                                     metric=metric))
        t0 = time.perf_counter()
        cpu = float(silhouette_score(xs[:SIL_SUB].cpu(),
                                     labels[:SIL_SUB].cpu(), metric=metric))
        cpu_s = time.perf_counter() - t0
        phase("cluster", part="silhouette", metric=metric, rows=SIL_ROWS,
              score=float(score), ms=ms, subset=SIL_SUB, subset_score=sub,
              subset_cpu_score=cpu, cpu_s=cpu_s,
              launches={k_: v for k_, v in launches.items() if v})
        if not (abs(sub - cpu) <= SIL_TOL and -1.0 <= float(score) <= 1.0):
            fail(f"silhouette {metric}: card {sub} vs CPU {cpu}")
        if metric == "cityblock":
            check_launched("silhouette cityblock", launches,
                           ("elementwise_dist",))
            row = elt_row("elementwise_dist@silhouette_l1", "l1",
                          xs[:256].contiguous(), xs,
                          launches["elementwise_dist"], 1.0)
    return row


def sparse_rows(g, m: int, k: int, nnz: int, dev):
    """CSR rows of ``bench_suite.bench_sparse_wide``'s form: ``nnz``
    random columns of ``k`` a row (a repeat keeps one value) with
    uniform values, made on the card."""
    from raft_tpu_torch import sparse
    dense = torch.zeros((m, k), device=dev)
    cols = torch.randint(0, k, (m, nnz), generator=g, device=dev)
    dense.scatter_(1, cols, torch.rand((m, nnz), generator=g, device=dev))
    out = sparse.dense_to_csr(dense)
    del dense
    return out


def run_sparse(seed: int, dev):
    """Phase 9d: the wide case against dense ``pairwise_distance`` of the
    densified rows; the narrow case at cityblock and jensenshannon, bit
    for bit against the dense function (kernel 7 rows); the sparse
    k-NN, its first SP_KNN[3] queries against ``torch.sparse.mm`` of the
    CSR rows."""
    from raft_tpu_torch import ops, sparse
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    m, n, k, nnz, tile = SP_WIDE
    a, b = sparse_rows(g, m, k, nnz, dev), sparse_rows(g, n, k, nnz, dev)
    wide = lambda: sparse.pairwise_distance(  # noqa: E731
        a, b, DistanceType.L2SqrtExpanded, col_tile=tile)
    got = wide()
    want = pairwise_distance(a.todense(), b.todense(), "euclidean")
    err = float((got - want).abs().max())
    wide_ms = cuda_ms(wide, 3)
    phase("cluster", part="sparse_wide", shape=[m, n, k], nnz_per_row=nnz,
          col_tile=tile, ms=wide_ms, max_abs_err_vs_dense=err)
    if err > SP_TOL * (1.0 + float(want.abs().max())):
        fail(f"sparse wide: {err} from the dense distance")
    del a, b, got, want
    rows = []
    m, n, k, density = SP_NARROW
    dense_a = torch.rand((m, k), generator=g, device=dev)
    dense_a *= torch.rand((m, k), generator=g, device=dev) < density
    dense_b = torch.rand((n, k), generator=g, device=dev)
    dense_b *= torch.rand((n, k), generator=g, device=dev) < density
    a, b = sparse.dense_to_csr(dense_a), sparse.dense_to_csr(dense_b)
    for name, tag, p_lib in (("cityblock", "l1", 1.0),
                             ("jensenshannon", "jensen_shannon", None)):
        from raft_tpu_torch.distance import DISTANCE_TYPES
        ops.reset_launch_counts()
        got, ms = cuda_once(lambda: sparse.pairwise_distance(
            a, b, DISTANCE_TYPES[name]))
        launches = ops.launch_counts()
        check_launched(f"sparse narrow {name}", launches,
                       ("elementwise_dist",))
        same = bool(torch.equal(got, pairwise_distance(dense_a, dense_b,
                                                       name)))
        phase("cluster", part="sparse_narrow", metric=name,
              shape=[m, n, k], density=density, ms=ms,
              equal_to_dense=same,
              launches={k_: v for k_, v in launches.items() if v})
        if not same:
            fail(f"sparse narrow {name}: differs from the dense distance")
        del got
        rows.append(elt_row(
            f"elementwise_dist@sparse_narrow_{'l1' if tag == 'l1' else 'js'}",
            tag, dense_a, dense_b, launches["elementwise_dist"], p_lib))
    del a, b, dense_a, dense_b
    nq, n, kk, checked = SP_KNN
    k, nnz = SP_WIDE[2], SP_WIDE[3]
    db, q = sparse_rows(g, n, k, nnz, dev), sparse_rows(g, nq, k, nnz, dev)
    (d, i), ms = cuda_once(lambda: sparse.brute_force_knn(db, q, kk))
    # the first queries by torch.sparse: |q|^2 + |x|^2 - 2 <q, x>
    qd = sparse.csr_slice_rows(q, 0, checked).todense()
    dbs = torch.sparse_csr_tensor(db.indptr.long(), db.indices.long(),
                                  db.data, db.shape, check_invariants=False)
    ip = torch.sparse.mm(dbs, qd.T).T
    xx = torch.zeros(n, device=dev).index_add_(
        0, db.row_ids().long(), db.data * db.data)
    ref = (qd * qd).sum(1)[:, None] + xx[None, :] - 2.0 * ip
    d_ref, i_ref = torch.topk(ref, kk, dim=1, largest=False)
    agree = float((i[:checked].long() == i_ref).double().mean())
    derr = float((d[:checked] - d_ref).abs().max())
    phase("cluster", part="sparse_knn", queries=nq, rows=n, features=k,
          nnz_per_row=nnz, k=kk, ms=ms, checked=checked,
          id_agreement=agree, max_abs_err=derr)
    if agree < MIN_ID_AGREEMENT or derr > SP_TOL * float(d_ref.max()):
        fail(f"sparse knn: ids agree on {agree}, distances off by {derr}")
    return rows


def run_select_approx(dev):
    """Phase 9e: ``select_k(mode="approx")`` on one batch: the ids of
    ``mode="exact"`` and kernel 2's launches risen."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.neighbors.selection import select_k
    rows, cols, k = APPROX
    v = torch.randn((rows, cols), device=dev)
    ops.reset_launch_counts()
    d_a, i_a = select_k(v, k, mode="approx", recall_target=0.9)
    launches = ops.launch_counts()["select_k"]
    d_e, i_e = select_k(v, k)
    same = bool(torch.equal(i_a, i_e) and torch.equal(d_a, d_e))
    phase("cluster", part="select_k_approx", shape=[rows, cols, k],
          equal_to_exact=same, select_k_launches=launches)
    if not same or launches < 1:
        fail(f"select_k approx: equal to exact {same}, launches {launches}")


def run_cluster(x, seed: int, dev):
    """Phase 9: the host-side users of kernels 1, 7 and 2."""
    t0 = time.perf_counter()
    centers, km_row = run_kmeans_fit(x[:KM_FIT_ROWS].contiguous())
    run_single_linkage(x)
    rows = [km_row, run_silhouette(x, centers)]
    rows += run_sparse(seed, dev)
    run_select_approx(dev)
    phase("cluster", seconds=time.perf_counter() - t0)
    return rows


def spectral_graph(x, k: int):
    """The kNN graph of ``x`` in ``sparse.neighbors.knn_graph``'s form
    (self edges dropped, mirrored edges merged) with unit weights, as
    CSR; the neighbours from the fused brute force (kernel 5 and its
    pass B) where ``knn_graph`` takes the exact tile scan."""
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    from raft_tpu_torch.sparse import COO, coo_to_csr, symmetrize
    n = x.shape[0]
    _, idx = brute_force_knn(x, x, k + 1, DistanceType.L2Expanded,
                             mode="fused", device=x.device)
    rows = torch.arange(n, dtype=torch.int32,
                        device=x.device).repeat_interleave(k + 1)
    cols = idx.reshape(-1)
    keep = rows != cols
    ones = torch.ones(int(keep.sum()), device=x.device)
    return coo_to_csr(symmetrize(COO(rows[keep], cols[keep], ones, (n, n)),
                                 "max"))


def timed(fn):
    """``(fn(), seconds)`` with the device synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_spectral(x, truth, blobs_s: float):
    """Phase 10a: ``spectral.partition`` of the blob points ``x`` on their
    kNN graph, its quality measures, then ``modularity_maximization`` on
    the same graph; kernel 1 held to its plain version at the k-means
    shape (the embedding against the partition's centroids)."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.spectral import (analyze_modularity,
                                         analyze_partition,
                                         modularity_maximization, partition)
    from raft_tpu_torch.spectral.partition import _transform_eigen_matrix
    from raft_tpu_torch.stats import adjusted_rand_index
    from raft_tpu_torch.util.segment import segment_sum
    k = SPEC_CLUSTERS
    ops.reset_launch_counts()
    graph, graph_s = timed(lambda: spectral_graph(x, SPEC_KNN))
    graph_launches = ops.launch_counts()
    ops.reset_launch_counts()
    (labels, evals, evecs), part_s = timed(lambda: partition(graph, k))
    part_shapes, part_l1 = l2nn_shapes(), ops.launch_counts()["fused_l2_nn"]
    (cut, cost), cut_s = timed(lambda: analyze_partition(graph, labels, k))
    q, q_s = timed(lambda: analyze_modularity(graph, labels, k))
    ops.reset_launch_counts()
    (m_labels, m_evals, m_evecs), mod_s = timed(
        lambda: modularity_maximization(graph, k))
    mod_shapes, mod_l1 = l2nn_shapes(), ops.launch_counts()["fused_l2_nn"]
    m_q = analyze_modularity(graph, m_labels, k)
    ari = float(adjusted_rand_index(truth, labels))
    m_ari = float(adjusted_rand_index(truth, m_labels))
    finite = all(bool(torch.isfinite(t).all()) for t in (
        evals, evecs, cut, cost, q, m_evals, m_evecs, m_q))
    in_range = all(int(lab.min()) >= 0 and int(lab.max()) < k
                   for lab in (labels, m_labels))
    ascending = bool((evals[1:] >= evals[:-1]).all()) and \
        -1e-3 <= float(evals[0]) and float(evals[-1]) <= 2 + 1e-3
    phase("primitives", part="spectral", n=SPEC_N, dim=SPEC_D, k=k,
          knn=SPEC_KNN, nnz=graph.nnz, seconds={
              "make_blobs": blobs_s, "knn_graph": graph_s,
              "partition": part_s, "analyze_partition": cut_s,
              "analyze_modularity": q_s, "modularity_maximization": mod_s},
          graph_launches={k_: v for k_, v in graph_launches.items() if v},
          eigenvalues=evals.tolist(), ari=ari, edge_cut=float(cut),
          cost=float(cost), modularity=float(q),
          modularity_eigenvalues=m_evals.tolist(), modularity_ari=m_ari,
          modularity_max_modularity=float(m_q),
          partition_fused_l2_nn_shapes=part_shapes,
          modularity_fused_l2_nn_shapes=mod_shapes)
    if not (finite and in_range and ascending):
        fail(f"spectral: finite {finite}, labels in [0, {k}) {in_range}, "
             f"eigenvalues ascending in [-1e-3, 2 + 1e-3] {ascending}")
    if part_l1 < 1 or mod_l1 < 1:
        fail(f"spectral: kernel 1 launches {part_l1} (partition), "
             f"{mod_l1} (modularity_maximization)")
    emb = _transform_eigen_matrix(evecs).contiguous()
    sums, counts = segment_sum(emb, labels, k)
    cents = (sums / counts.clamp(min=1)[:, None].float()).contiguous()
    row = check_fused_l2_nn(emb, cents, "fused_l2_nn@spectral")
    row["launches"] = part_l1 + mod_l1
    return row


def run_dense(x, seed: int, dev):
    """Phase 10b: rsvd of a low-rank-plus-noise matrix against
    ``torch.linalg.svdvals``; eig_dc and svd_qr with their reconstruction
    residuals; lstsq_qr with its normal-equations residual; cov and
    meanvar of the blobs against float64."""
    from raft_tpu_torch import linalg, stats
    g = torch.Generator(device=dev).manual_seed(seed)
    m, n = RSVD_SHAPE

    def orth(rows):
        return torch.linalg.qr(torch.randn((rows, RSVD_K), generator=g,
                                           device=dev))[0]

    sv = torch.logspace(3, 1.7, RSVD_K, device=dev)
    a = (orth(m) * sv) @ orth(n).T + 0.01 * torch.randn(
        (m, n), generator=g, device=dev)
    (_, s, _), rsvd_s = timed(lambda: linalg.rsvd(a, RSVD_K, seed=seed))
    ref, svdvals_s = timed(lambda: torch.linalg.svdvals(
        a, driver="gesvd")[:RSVD_K])
    rsvd_err = float(((s - ref).abs() / ref).max())
    del a
    b = torch.randn((DENSE_N, DENSE_N), generator=g, device=dev)
    sym = (b + b.T) / 2
    (w, v), eig_s = timed(lambda: linalg.eig_dc(sym))
    eig_res = float(torch.linalg.norm(sym @ v - v * w)
                    / torch.linalg.norm(sym))
    (u, sig, vv), svd_s = timed(lambda: linalg.svd_qr(b))
    svd_res = float(torch.linalg.norm(linalg.svd_reconstruction(u, sig, vv)
                                      - b) / torch.linalg.norm(b))
    del b, sym, w, v, u, sig, vv
    lm, ln = LSTSQ_SHAPE
    la = torch.randn((lm, ln), generator=g, device=dev)
    lb = la @ torch.randn(ln, generator=g, device=dev) + 0.1 * torch.randn(
        lm, generator=g, device=dev)
    sol, lstsq_s = timed(lambda: linalg.lstsq_qr(la, lb))
    lstsq_res = float(torch.linalg.norm(la.T @ (la @ sol - lb))
                      / torch.linalg.norm(la.T @ lb))
    del la, lb
    c, cov_s = timed(lambda: stats.cov(x))
    (mu, var), mv_s = timed(lambda: stats.meanvar(x))
    xd = x.double()
    c64 = torch.cov(xd.T)
    cov_err = float((c.double() - c64).abs().max() / c64.abs().max())
    mv_err = max(float((mu.double() - xd.mean(0)).abs().max()),
                 float(((var.double() - xd.var(0)) / xd.var(0)).abs().max()))
    del xd
    phase("primitives", part="dense", rsvd_shape=[m, n, RSVD_K],
          rsvd_max_rel_err=rsvd_err, eig_dc_residual=eig_res,
          svd_qr_residual=svd_res, lstsq_qr_shape=list(LSTSQ_SHAPE),
          lstsq_normal_residual=lstsq_res, cov_rel_err=cov_err,
          meanvar_err=mv_err, seconds={
              "rsvd": rsvd_s, "svdvals": svdvals_s, "eig_dc": eig_s,
              "svd_qr": svd_s, "lstsq_qr": lstsq_s, "cov": cov_s,
              "meanvar": mv_s})
    if not (rsvd_err <= RSVD_TOL and max(eig_res, svd_res, lstsq_res,
                                         cov_err, mv_err) <= RESID_TOL):
        fail(f"dense: rsvd {rsvd_err}, eig {eig_res}, svd {svd_res}, "
             f"lstsq {lstsq_res}, cov {cov_err}, meanvar {mv_err}")


def run_assignment(seed: int, dev):
    """Phase 10c: the auction at LAP_N on integer costs, a permutation,
    its objective beside scipy's optimum (not gated: six ε-phases stop
    short of ε·n < 0.5 at this n) and the rounds of each phase."""
    from scipy.optimize import linear_sum_assignment
    from raft_tpu_torch.solver import LinearAssignmentProblem
    g = torch.Generator(device=dev).manual_seed(seed)
    cost = torch.randint(0, 1000, (LAP_N, LAP_N), generator=g,
                         device=dev).float()
    lap = LinearAssignmentProblem(LAP_N)
    obj, secs = timed(lambda: lap.solve(cost))
    rows = lap.get_row_assignment_vector()
    perm = bool(torch.equal(torch.sort(rows.long()).values,
                            torch.arange(LAP_N, device=dev)))
    c = cost.cpu().numpy()
    t0 = time.perf_counter()
    ri, ci = linear_sum_assignment(c)
    scipy_s = time.perf_counter() - t0
    phase("primitives", part="linear_assignment", n=LAP_N,
          objective=float(obj), scipy_objective=float(c[ri, ci].sum()),
          rounds_per_phase=lap.rounds_per_phase, permutation=perm,
          seconds=secs, scipy_seconds=scipy_s)
    if not perm:
        fail("linear_assignment: the row assignment is not a permutation")


def run_generators(seed: int, dev):
    """Phase 10d: R-MAT at Graph500's scale 20, edge factor 16 (top-level
    quadrant shares against theta), make_regression's noise-free targets
    against x @ coef + bias."""
    from raft_tpu_torch.random import (RngState, make_regression,
                                       rmat_rectangular_gen)
    n_edges = RMAT_EDGE_FACTOR << RMAT_SCALE
    (src, dst), rmat_s = timed(lambda: rmat_rectangular_gen(
        RngState(seed, device=dev), list(RMAT_THETA), RMAT_SCALE, RMAT_SCALE,
        n_edges))
    top = RMAT_SCALE - 1
    quad = ((src >> top) * 2 + (dst >> top)).long()
    shares = (torch.bincount(quad, minlength=4).double() / n_edges).tolist()
    in_range = int(src.min()) >= 0 and int(max(src.max(), dst.max())) < \
        (1 << RMAT_SCALE) and int(dst.min()) >= 0
    del src, dst, quad
    rows, cols = REG_SHAPE
    (x, y, w), reg_s = timed(lambda: make_regression(
        rows, cols, bias=2.5, coef=True, seed=RngState(seed, device=dev)))
    ref = (x @ w)[:, 0] + 2.5
    reg_err = float((y - ref).abs().max() / ref.abs().max())
    phase("primitives", part="generators", rmat_scale=RMAT_SCALE,
          rmat_edges=n_edges, rmat_top_shares=shares, rmat_in_range=in_range,
          regression_shape=list(REG_SHAPE), regression_rel_err=reg_err,
          seconds={"rmat": rmat_s, "make_regression": reg_s})
    off = max(abs(a - b) for a, b in zip(shares, RMAT_THETA))
    if off > RMAT_TOL or not in_range or not reg_err <= REG_TOL:
        fail(f"generators: rmat shares {shares} (theta {RMAT_THETA}), in "
             f"range {in_range}; make_regression rel err {reg_err}")


def run_primitives(seed: int, dev):
    """Phase 10: the dense primitives and spectral partitioning."""
    from raft_tpu_torch.random import make_blobs
    t0 = time.perf_counter()
    (x, truth), blobs_s = timed(lambda: make_blobs(
        SPEC_N, SPEC_D, centers=SPEC_CLUSTERS, cluster_std=1.0, seed=seed,
        device=dev))
    row = run_spectral(x, truth, blobs_s)
    run_dense(x, seed, dev)
    del x, truth
    run_assignment(seed, dev)
    run_generators(seed, dev)
    phase("primitives", seconds=time.perf_counter() - t0)
    return [row]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000,
                    help="dataset rows (default 10M; a cut is printed)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="after each measured burst, trace a second one "
                    "with torch.profiler (device time by kernel)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs only on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "raft_tpu_torch")):
        fail("raft_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, here)
    from raft_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = gpu_line()
    os.makedirs(OUT_DIR, exist_ok=True)

    # 1. build
    secs, reports = _build.build_all(verbose=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"== {name}\n{text}\n")
    phase("build", seconds=secs, kernels=list(_build.KERNEL_SOURCES),
          ptxas=ptxas_summary(reports))

    x, q, q_bf = ann_dataset(args.n, D, N_QUERIES, args.seed, dev)
    if args.n != 10_000_000:
        phase("cut", n=args.n, note="dataset cut from 10,000,000 rows")
    q_np = q.cpu().numpy()

    # 2a. kernels vs plain at the IVF-Flat path's k-means, predict and
    # coarse shapes (the sampled rows stand in for N_LISTS centres)
    cent = sample_rows(x, N_LISTS, 12)
    sample = sample_rows(x, KM_ROWS, 11)
    flat_rows = [check_fused_l2_nn(sample, cent, "fused_l2_nn"),
                 check_fused_l2_nn(x, cent, "fused_l2_nn@predict"),
                 check_select_k(q, cent, N_PROBES, "select_k")]
    # 2b. the trainer and kernel 1 at its other tiers
    tier_rows = run_kmeans_tiers(x, sample, cent,
                                 sample_rows(x, PQ_LISTS, 14))
    del cent, sample

    # the exact truth of the 256 queries, by the port's exact scan
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors.brute_force import brute_force_knn
    t0 = time.perf_counter()
    truth = brute_force_knn(x, q, K, DistanceType.L2Expanded,
                            mode="exact")[1].cpu().numpy()
    phase("truth", nq=N_QUERIES, k=K, seconds=time.perf_counter() - t0)

    # 3. the IVF-Flat path, with its k > 256 search; 3b, 3c. the same at
    # bf16 and int8 list storage (rows carry their own launches)
    scan_rows, flat_launches, wide_rows, wide_launches, served = run_flat(
        x, q, q_np, truth, args)
    flat_rows += scan_rows
    # 3a. the mesh-wide tier over a list-sharded build (rows carry their
    # own launches)
    dist_rows, gathered = run_serve_dist(x, q, q_np, truth, served,
                                         args.profile)
    # 3d, 3e. mesh-wide mutable serving over the gathered index, then the
    # row-sharded multi-part indexes
    dist_rows += run_serve_dist_mutate(gathered, x, q, q_np, args.seed)
    dist_rows += run_serve_parts(x, q, q_np, truth)
    narrow_rows = [r for st in FLAT_STORAGES
                   for r in run_flat_narrow(x, q, q_np, truth, args, st)]

    # 4., 5. the IVF-PQ and IVF-BQ paths; 5b, 5c. the same points grown by
    # extend (IVF-PQ with per-cluster books), their recall beside the
    # first's
    paths = [(flat_rows, flat_launches), (wide_rows, wide_launches),
             (dist_rows, None)]
    recalls = {}
    for fam in FAMILIES:
        rows, counts, recalls[fam.module] = run_family(fam, x, q, q_np,
                                                       truth, args)
        paths.append((rows, counts))
    for fam in GROWN:
        rows, counts, _ = run_family(
            fam, x, q, q_np, truth, args,
            {f"main_{fam.tag.split('_')[0]}_recall_at_{K}":
             recalls[fam.module]})
        paths.append((rows, counts))
    # 5d. the two-level trainer at the 10M rows
    run_two_level(x)

    # launches: each row's kernel over the main-path run of its path,
    # where the row does not carry its own
    for rows, counts in paths:
        for row in rows:
            if row["launches"] is not None:
                continue
            key = row["name"].split("@")[0]
            row["launches"] = counts["ivf_scan" if key == "ivf_flat_scan"
                                     else key]

    # 2b, 3b, 3c, 6.-9. kernel 1's tiers, IVF-Flat's narrow storages,
    # brute force and pairwise distances: rows carry their own path's
    # launches
    paths.append((tier_rows, None))
    paths.append((narrow_rows, None))
    paths.append((run_bf(x, q_bf, args), None))
    paths.append((run_wide_bf(args.seed, dev), None))
    paths.append((run_pairwise(x[:L1_ROWS], q_bf[:L1_QUERIES], args.seed,
                               dev), None))
    # 9. the host-side users of the distances
    paths.append((run_cluster(x, args.seed, dev), None))
    # 10. the dense primitives and spectral partitioning
    paths.append((run_primitives(args.seed, dev), None))

    kernels = [r for rows, _ in paths for r in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
