#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kube_batch_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the four kernels from their sources, one nvcc each, at once:
   csrc/fused_solve.cu (B1, the whole solve), csrc/block_step.cu (B2,
   one shard's block step), csrc/class_step.cu (B3, one
   class-compressed segment) and csrc/mesh_solve.cu (B4, the mesh rung's
   whole gang loop, one launch a card, B1's loop from
   csrc/solve_loop.cuh), with the probes csrc/class_floor.cu and
   csrc/mesh_floor.cu, and prints each entry function's registers,
   spills and static shared memory from ptxas;
   then runs the card tests (the ``cuda``-marked tests of ``CARD_TESTS``,
   pytest in a subprocess): bit-equality at the cluster's slice bounds,
   ties across CTAs, pauses, global scratch, B3 on seeded segments;
3. holds B1 against its plain version (fused_solve_plain, on the CPU) on
   the same packed inputs of five worlds, ``preempt_mix(50_000, 1_000)``
   the largest: integer state exactly, float state bit for bit (the
   float32 operations and their order are the same on both sides, so no
   tolerance is allowed). At 50k x 5k the whole solve's plain run takes
   minutes of host CPU, so there B1 is held against it over a prefix (the
   first sixteenth of the job rows active) and, over the whole solve,
   through the sharded path (5), whose kernel shares B1's node arithmetic;
4. holds B2 against its plain version (block_step_plain, on the CPU), bit
   for bit, on full-width blocks: the 5,120-node block of
   ``preempt_mix(50_000, 5_000)`` from its entry state and from a
   mid-solve state for one task of every class, the same state split into
   four blocks (non-zero offsets), ``multi_tenant_ml(200, 500)`` (scalar
   resources) with host-port collisions, and a block with no candidate;
   times one call at each block width the main path launches (5,120,
   1,280 and 256 nodes): ``ms`` is the time per call of back-to-back
   launches from Python (CUDA events), as in every earlier run, and
   ``device_ms`` the kernel's own time per launch from the profiler's
   device trace, taken after every main path has run (so the profiler
   cannot slow them), null where the trace holds none;
5. drives the entry point on each of its two device rungs, with the launch
   counters zeroed just before each path and read just after:
   - the fused rung, ``allocate(..., device="cuda")``, on
     ``preempt_mix(50_000, 5_000)`` (capacity to spare) and
     ``preempt_mix(50_000, 1_000)`` (capacity runs short, so tasks
     pipeline onto releasing capacity);
   - the sharded rung, ``allocate(..., mesh=...)``, on 50k x 5k with one
     shard and with four shards on cuda:0, and on 50k x 1k with four;
     each must launch B4 once (one card) and B2 never, and give the fused
     rung's binds, pipelined tasks and SolveState, integers exactly and
     floats as values;
   - ``mesh_solve_vs_plain``: on ``preempt_mix(2000, 40, seed=1)`` and on
     ``preempt_mix(50_000, 5_000)``, each on four shards of cuda:0, B4,
     the host loop with B2 on the card (``impl="host_loop"``, which no
     conf reaches) and B1 give the same SolveState field for field; at
     2k x 40 B4 also equals its plain version on the CPU (the same
     grouping of the shards into one card) bit for bit, and is timed
     (CUDA events around its launch; ``ms``) beside it; at 50k x 5k, from
     a prefix of the jobs, B4 equals its plain version on four CPU cards,
     and the K = 4 batched exchange over four cards of one solve on
     cuda:0 gives the round's split (``b4_split``: the kernel's timed
     instantiation, each part of every round on %globaltimer; the rounds
     and speculated iterations per committed one; the chain's floor and
     the bound against B1's floor and the round probe on one device);
   and checks every result's binds (no node past its idle or releasing
   capacity + eps, every bound job at its gang minimum);
6. runs the per-iteration exchange and the K-deep batched exchange, both
   on B4 (``preempt_mix(2000, 40, seed=1)``, four shards of cuda:0, K = 1
   and K = 4), each timed and held against the fused rung, K = 4 also
   against B4's plain version at K = 4; K = 1 through the JAX GSPMD rung's
   surface (``parallel.sharded.ShardedSolver``) with a tensor arena, then
   ``sharded_solve_allocate`` on that arena (``sharded_surface``: the
   static blocks reused, the fused rung's result); the host loop over B2
   at K = 4 (``host_loop_k4``, reached by ``impl="host_loop"`` only: B2's
   path); and ``b4_by_k``: B4 at K = 1, 2, 4 and 8 on the four shards of
   one card and over four cards of one solve on cuda:0 (a stream each:
   the batched exchange's rounds between cards), each held to the fused
   rung, with its device time, rounds and speculated iterations, and at
   K = 2, 4 and 8 the round's split (``b4_split``);
7. drives the scheduling cycle, ``Scheduler(FakeCache(world),
   conf).run_once()`` with ``examples/scheduler-conf-torch.yaml``, the
   counters zeroed just before each cycle and read just after:
   - ``scheduler_fused``: ``preempt_mix(50_000, 5_000)`` on the fused
     rung, one B1 launch, binds equal to ``allocate``'s (step 5);
   - ``scheduler_sharded``: ``preempt_mix(50_000, 1_000)`` with
     ``mesh: cuda:4`` (four shards on the one card), one B4 launch and no
     B2, binds equal to the fused rung's;
   - ``scheduler_affinity``: ``preempt_mix(10_000, 1_000)`` with 36 pods
     carrying required pod (anti-)affinity terms, on both rungs: host
     steps (each a pause, a serial step of the task, a resume), the same
     count, binds and final SolveState on both;
   each prints ``run_once``'s wall clock and its split (snapshot, plugins,
   the JobValid gate, the action's own split, backfill, close);
   - ``size_floor`` (a measurement, not a main path): ``run_once`` with
     the serial allocate against the fused rung on six small
     ``preempt_mix`` worlds (100 to 102,400 pending tasks x nodes), three
     cycles each, equal binds, and the example conf as it is on each, which
     must run serially exactly below torch_allocate's size floor;
   a failed cycle phase does not stop the others; the script then exits
   non-zero;
8. drives the whole pipeline, ``Scheduler(FakeCache(world),
   "examples/scheduler-conf-torch-pipeline.yaml").run_once()`` (enqueue,
   torch_reclaim, torch_allocate, torch_backfill, torch_preempt with
   tensorscore), the counters zeroed just before each cycle and read just
   after; each phase prints ``run_once``'s wall clock, the per-action
   split (``<action>_s``, and each scan action's float64 encode and
   walk), binds, evicts by reason, ``check_binds``' verdict on the
   allocate step, and the launches, and fails without a B1 launch:
   - ``pipeline_fused_50k_5k``: ``preempt_mix(50_000, 5_000)``, one B1
     launch, binds equal to ``allocate``'s (and so ``scheduler_fused``'s);
   - ``pipeline_fused_50k_1k``: ``preempt_mix(50_000, 1_000)`` with pods
     and nodes halved (``PREEMPT_WALK_CUT``, ``reduced`` in its record):
     starved gangs remain, torch_preempt evicts priority-1 residents,
     binds equal to ``allocate``'s on the same world;
   - ``pipeline_reclaim``: ``reclaim_world(38_500, 1_000)`` (cut from
     50,000 pods, ``reduced`` in its record), config 4 with its residents
     in running gang jobs of an over-served second queue; torch_reclaim
     evicts;
   - ``pipeline_parity``: the twin conf against the serial scans around
     the same device allocate (``enqueue, reclaim, torch_allocate,
     backfill, preempt`` with nodeorder), both with ``min_device_pairs:
     0``, on seeds 0-11 of ``gen_contended_cluster`` and
     ``gen_contended_reclaim_cluster`` and on ``preempt_mix(2000, 40,
     seed=1)``: equal task states, binds and evict lists, more than 10
     binds and 10 evicts over the sweep;
   a failed pipeline phase does not stop the others either;
9. drives the host fast paths (the native hot loops, built with g++ as
   ``native_build`` beside the kernels' nvcc build, which fails the run if
   they cannot be built or loaded, and the cross-cycle encode cache):
   - ``encode_cache_100k_10k``: one session over ``preempt_mix(100_000,
     10_000)``, at float32 and float64: a cold encode, a warm one, one
     after replacing 1% of the Node objects, one after replacing 1% of the
     pending pods (through the dirty feed), and a cold one again; every
     warm encode byte-identical to a cold encode of the same world;
   - ``warm_cycles_50k_5k``: the twin pipeline's ``Scheduler`` over
     ``preempt_mix(50_000, 5_000)``, three ``run_once`` (cold; nothing
     changed; 1% of the Node objects replaced and one new gang), the
     counters zeroed just before each cycle and read just after, against
     a second scheduler on a twin cache with the cache and the native
     loops off: equal task states, binds and evicts cycle for cycle; each
     cycle's encodes, warm fractions, ``pack_s``, ``replay_s`` and native
     call counts;
   - ``native_parity``: ``scheduler_fused`` and ``pipeline_parity``'s 25
     worlds with the native loops on and off (equal), and B1 on two worlds
     packed with native class numbering and with ``np.unique``'s, each
     bit-equal to its plain version, equal states and binds;
   any native fallback or fired fault point fails the run;
10. drives the solver ladder under injected faults and the cycle under
   trace (the twin pipeline's ``Scheduler`` throughout):
   - ``ladder_drills``: on ``preempt_mix(2000, 40, seed=1)``, each drill
     under a fresh solver ladder (threshold 3), the process ladder
     restored after: (a) ``solve.fused`` once, a serial cycle
     (``solve_failed``); (b) three such cycles open the ``fused`` breaker,
     the next cycle runs serially (``breaker_open``) with no launch, and
     after the backoff the probe cycle launches B1 once and closes it
     (closed -> open -> half_open -> closed); (c) ``mesh: cuda:4`` with
     ``solve.sharded`` once, B2 launches and the fused rung resumes in the
     same cycle with one B1 launch; (d) ``solve.nan``, serial
     (``nonfinite``) with no launch; (e) ``cycle.overrun``, an aborted
     cycle with no bind and PodGroup phases as before, then a cycle that
     binds; (f) a soft deadline of 1 us for three cycles: on ``mesh:
     cuda:4`` it trips the ``sharded`` tier and the next cycle solves on
     the fused rung; on the fused rung the overruns are counted and the
     cycles stay on the card (the rung below is the CPU); (g) ``python -m
     kube_batch_tpu_torch.faults.smoke`` on the card passes its five
     drills; every cycle's binds and task states equal an undisturbed
     fused cycle's;
   - ``overrun_50k_5k``: (e) at ``preempt_mix(50_000, 5_000)``, the second
     cycle's binds equal ``allocate``'s;
   - ``traced_cycles_50k_5k``: warm_cycles_50k_5k's three cycles with
     ``trace: "on"`` against the same cycles with tracing off (equal binds,
     evicts and task states): ``check_tree``, the span tree per cycle,
     each span beside its ``last_timings`` entry, the Chrome trace written
     to ``chiprun_out/traced_cycles_50k_5k.trace.json``, and the
     exposition after the traced cycles (``schedule_attempts`` up by 3,
     ``breaker_state{tier="fused"}`` 0, no degraded cycle, five action
     latencies per cycle), then the warm cycle traced and untraced in
     alternation (``KBT_TRACE`` flipped), with the cyclic collector on
     and held off during the cycle, their medians and spreads;
   every phase outside the drills fails on any degraded cycle, breaker
   transition, fired fault point or native fallback during it;
11. drives the port as a process (the store, the cache and its write
   side, the ``Scheduler.run`` loop on its ``kb-loop`` thread, the HTTP
   surface; the twin pipeline conf), the main worlds freed first; this
   step's and step 12's worlds are divided by ``PROCESS_CUT`` (2: 25,000
   pods on 2,500 nodes, the uncut counts in each record's ``reduced``):
   - ``server_50k_5k``: ``preempt_mix(50_000, 5_000)`` generated twice
     from its seed, once as the FakeCache world of one twin-pipeline
     cycle (``pipeline_cycle``), once into a ``ClusterStore`` through its
     API (55,001 objects, PodGroups Pending: ``ingest_s``); then
     ``SchedulerServer(store=..., schedule_period=1.0, device="cuda:0")``
     (``cache_sync_s``: the store's replay into the cache, inside the
     constructor) runs until the store shows every bind of the FakeCache
     cycle (at most 180 s; ``write_back_s``: from the cycle's
     ``bind_many`` to the last store bind event); no gang partly bound,
     no node past its allocatable; a probe gang (8 pods of 1 cpu / 2Gi,
     ``min_member`` 8) posted over HTTP binds in full (``probe_bind_s``
     from its last POST); ``/healthz``, ``/version``, ``/metrics`` and
     ``/apis/v1alpha1/podgroups`` answer 200; ``stop()`` joins every
     thread it started. Each cycle's ``run_once_s``, split, pending tasks,
     ``encode_s``, ``warm_fraction``, B1's time and launches,
     ``replay_s``, ``gc_s`` and rung; a cycle that fails (the loop logs
     it and goes on; the phase reads it), aborts, or has pending tasks
     and solves below the fused rung fails the phase;
   - ``server_drills`` (``preempt_mix(2000, 40, seed=1)`` in a store, the
     twin conf with ``min_device_pairs: 0``, three cycles a run over a
     fresh store, the cache's pools running): (a) ``bind.write`` once,
     retried in place (``write_retries_total{op="bind"}`` +1); (b)
     ``bind.write`` with ``KBT_WRITE_RETRIES=0``: the rejected pod binds
     on a later cycle through the errTasks resync, and the run ends with
     the same drill's binds on the CPU; (c) ``snapshot_age`` past
     ``KBT_MAX_SNAPSHOT_AGE_S``: the first cycle is skipped
     (``stale_cycles_skipped_total`` +1) and binds nothing; (d)
     ``KBT_CACHE_MUTATION_DETECTOR=1``: no violation. (a), (c) and (d)
     end with the undisturbed run's binds;
   - ``ha_failover_50k_5k``: the port as an HA pair over a store seeded
     with ``preempt_mix(50_000, 5_000)``, an arbiter server holding the
     lease (``HA_LEASE``: 6.0 / 4.2 / 0.6 s). Leader A (``SchedulerServer``
     with a journal, period 1 s, on ``cuda:0``) solves the world and dies
     in its write-back after 20,000 store binds (``DyingBinder``: a
     ``BaseException`` in the kb-write pool); its renewals stop with no
     release and its server stops. Standby B, blocked in ``acquire``,
     takes the lease once it runs out, reconciles the journal in
     ``start()`` under the mutation detector and runs its loop. The store
     must end at ``server_50k_5k``'s FakeCache binds, each pod bound once,
     no gang partly bound, no node past its allocatable, the
     ``ReconcileReport`` re-dispatching the other 30,000 with nothing
     rolled back, no intent outstanding and ``fsck --strict`` clean.
     Records ``journal_append_s``, the leader's ms per bind, its confirms'
     and compactions' time, ``takeover_s``, ``reconcile_s``,
     ``all_bound_s`` and each cycle's ``gc_s``;
   - ``ha_drills`` (``preempt_mix(2000, 40, seed=1)`` in a store, lease 2.0
     / 1.4 / 0.2 s, each drill on the card and again on the CPU, ending
     equal): (a) two ``LeaderElector``s on one lock file; (b)
     ``lease.renew``: on_lost after the renew deadline with the lease
     already released, the standby in at once; (c) ``journal.append``:
     the bulk statement unjournaled, its binds landed and counted as
     ``append_failed``; (d) ``journal.replay`` and (e) ``reconcile.scan``
     at takeover after the leader died mid-``bind_many``: reconciliation
     aborts, the standby's loop heals; (f) the leader dies mid-
     ``bind_many``, a node an orphaned gang targets is deleted, the gang
     rolls back and the standby binds it elsewhere. Every drill ends with
     every gang bound whole or not at all;
12. drives the port as a federation (``federation.py``, ``cache/backend.py``,
   ``/backend/v1/``):
   - ``federation_50k_5k``: the compose file's ``federation`` profile at
     full width. The store is a ``SchedulerServer`` in this process
     (scheduler name ``store-arbiter``, so its loop solves nothing) over a
     ``ClusterStore`` seeded with ``preempt_mix_objects(50_000, 5_000)``;
     two shard processes, ``python -m kube_batch_tpu_torch.server
     --store-backend URL --scheduler-conf <the twin conf on cuda>`` with
     ``KBT_FEDERATION=0/2`` and ``1/2``, ``KBT_SHARD_KEY=gang`` and
     ``KBT_TRACE=1``, both on ``cuda:0``. Gates: every pending pod bound
     exactly once (a store handler counts ``""`` -> node), ``fsck``
     clean, the bound set ``server_50k_5k``'s FakeCache cycle's, no shard
     cycle below the fused rung and no degradation in either shard's
     exposition or native fallback in its log, the binary codec (wire v2)
     on each shard's bytes and coalesced batches at the store, both
     processes ended by SIGINT with code 0 (their logs' tails printed
     otherwise; the logs under ``chiprun_out/``). Records each shard's
     start, its list round trips, its first working cycle's span split
     (the ``solve`` span holds B1), its coalesced batches, its conflict
     series and retries from ``/metrics``, the wire bytes per bind and
     ``all_bound_s``;
   - ``federation_scaleout_50k_5k``: bench.py's ``federation_scaleout_row``
     at N = 4, its depth quartered for the script's clock (``SCALEOUT_CUT``
     and ``PROCESS_CUT``): 1,250 gangs x 10 pods on 1,250 nodes (the row's
     5,000 x 10 on 5,000 in the record's ``reduced``), four
     ``FederatedCache`` + ``Scheduler`` threads over one ``ClusterStore``
     (``enqueue, torch_allocate``, the size floor off) on ``cuda:0``:
     ``drain_s`` within 300 s, binds/s, the conflict deltas, B1 launches
     and encode ``warm_fraction`` per shard, exactly once, ``fsck`` clean;
   - ``federation_drills`` (``federation.smoke``'s world, each drill on the
     card and again on the CPU, ending equal): (a) the kill drill, the
     owner dying mid-``bind_many``; (b) ``federation.stale_assign``; (c)
     ``store.txn_batch``; (d) ``federation.partition``; (e) ``shard.adopt``
     failing once; (f) a graceful handoff and ``shard.handoff`` failing;
     (g) ``shard.lease_flap``; (h) a v2 client against a v1-pinned server;
13. drives the port as a streaming scheduler (``streaming.py``,
   ``pipeline.py``, ``Scheduler.run_micro``, torch_allocate's micro path
   and deferred dispatch), the counters zeroed just before each phase's
   main path and read just after:
   - ``streaming_100k``: bench.py's ``sustained_arrival_row`` at its
     defaults. A ``ClusterStore`` of 1,000 nodes (128 cpu / 256Gi / 110
     pods) holding 1,000 resident gangs x 100 Running pods of 1 cpu / 2Gi;
     ``Scheduler.run`` on ``cuda:0`` with ``enqueue, torch_allocate``
     (priority, gang, conformance, predicates, nodeorder),
     ``streaming: true`` and a 60 s backstop period; 2 warm-up gangs, 6
     probe gangs one at a time, then 40 gangs of 8 pods as Poisson
     arrivals at 400 pods/s with a node label flip every 10th. Records
     the probes' time to bind and its p50, sustained pods/s and the
     arrivals' p50/p90/p99 time to bind (arrival to the store's bind
     event), micro-cycles by outcome, B1 launches, each probe's
     micro-cycle split (the action's encode, pack, state upload, B1,
     fetch and replay, the scheduler's open and close, and the gang's last
     store bind after the action returned) and kernel builds after the
     warm-up (``ops.nvcc.builds``). Fails unless every arrival binds as
     ONE full cycle of a twin store (the same world, arrivals and churn)
     places it, no micro-cycle ends otherwise than ``ok`` or ``empty``,
     every micro-cycle that solved did so on the fused rung, no kernel was
     built after the warm-up and the ``fused`` breaker stays closed;
   - ``pipelined_50k_5k``: bench.py's ``preempt_50k_5k_pipelined``:
     ``preempt_mix(50_000, 5_000)`` through ``Scheduler.run_once`` with
     examples/scheduler-conf-torch.yaml's tiers and ``torch_allocate``
     alone (a later action joins the deferred dispatch before it runs),
     on the fused rung, one warm and 3 measured sessions back to back
     (each a fresh FakeCache over the same world, all built and the
     garbage collected before the column) without ``KBT_PIPELINE``, then
     as many with ``KBT_PIPELINE=1`` (the post-solve replay and dispatch
     deferred onto the pipeline's thread, joined by the next session's
     fence). Records each column's ``run_once`` times and wall clock, the
     deferred dispatch seconds, the measured ``pipeline_overlap_fraction``
     and the fence waits. Fails unless every
     session's binds equal the synchronous column's, a dispatch was
     deferred, the pipeline never degraded, and ``cycle.overrun`` under
     the pipeline aborts a session with no bind and nothing deferred, the
     next one binding as the synchronous column;
   - ``streaming_drills``, each on the card and again on the CPU, ending
     equal: (a) ``streaming.smoke``; (b) ``federation.smoke_streaming``
     (2 absorb-mode shards); (c) ``stream.micro_cycle`` once, degrading
     to a full cycle with no pod dropped; (d) ``pipeline.fence`` once,
     the pipeline degrading stickily while the synchronous cycles bind
     every gang once; (e) a leader killed after 4 binds of its deferred
     dispatch, whose journal a standby reconciles before one full cycle
     ends at the uninterrupted twin's placements;
14. drives the port's operator surfaces (``obs/explain.py`` with
   ``ops/explain.py``'s batched pass, ``obs/fleet.py``, ``admission.py``
   and their server routes), the counters read as each phase's deltas:
   - ``explain_50k_1k``: ``preempt_mix(50_000, 1_000)`` through
     ``Scheduler.run_once`` with ``enqueue, torch_allocate`` (the cycle
     conf's tiers) on the fused rung, once with ``KBT_EXPLAIN`` off and
     twice on (a fresh FakeCache each; the first explain cycle pays the
     first launch of the pass's kernels, the second is the one held and
     timed). Fails unless the binds and the two cycles' records are equal,
     the records the cycle published equal ``explain_rows_np``'s over the
     same final state as canonical JSON, and the pass on the card (the
     cycle's own and re-runs) equals the same call on the CPU bit for bit.
     Records G (the pending gangs explained), ``explain_s`` (the pass with
     its fetch and the publish), the pass's device time (CUDA events over
     re-runs), its share of the cycle and the B1 launches;
   - ``explain_drills``, each on the card and again on the CPU, ending
     equal: (a) ``obs.explain.smoke``: the per-plane world's records
     through serial allocate, the fused rung and the sharded rung (``mesh:
     cuda:2``), all equal; (b) a streaming micro-cycle that explains its
     dirty gang only; (c) journal intents that carry ``explain``; (d)
     ``/debug/explain``, the reason counter on ``/metrics`` and ``kbt-ctl
     explain`` over a server whose loop scheduled the store;
   - ``fleet_smoke``: ``obs.fleet.smoke(shards=2)`` (two loopback shards
     over a store server, on the card): merged p50/p90/p99 within the
     sketch's declared relative error of the pooled samples, exact sample
     counts, every pod bound once, ``fsck`` clean, and ``fleet_shard_up``
     flipping for the killed observatory;
   - ``admission_storm``: ``admission.smoke()`` (the fake-clock plant),
     then ``admission.storm_row(shards=2, duration_s=8.0)``: the storm with
     admission on, off and with a shard killed, each checked by its own
     invariants (exactly once, ``fsck`` clean, drained, every 429 with
     Retry-After, micro-cycles ran; on: the protected lane never shed and
     its p99 within the storm's bound; kill: a measured MTTR and no
     orphaned journal intent). Records each lane's offered, admitted and
     shed counts, pods/s, the protected lane's p99 against the storm's SLO,
     the MTTR and the B1 launches of the shards' micro-cycles;
15. drives the class-compressed solve (``ops/class_solve.py``, kernel B3,
   ``KBT_CLASS_COMPRESS``), the counters zeroed just before each session
   and read just after:
   - ``classes_400k_40k``: ``uniform_pool(400_000, 40_000, churn=0.01)``,
     config 7 at full width (bench.py's ``uniform_pool_400k_40k_classes``;
     ``CLASS_CUT`` divides its pods, not its nodes), one ``enqueue,
     torch_allocate`` session compressed (B3 only) against the same
     snapshot on B1 (k = 16), bind for bind, then a churn session with a
     fresh salt on the warm table: ``c_pad`` holds and nothing is built.
     Records the class table's stats, ``group_s``, ``kernel_s``, B3's
     device time summed over segments (CUDA events around each in-place
     launch alone) and launches, the cost of a segment inside the solve
     (``segment_ms_in_solve``: ``kernel_s`` over the launches, host clock
     from the launch to the overflow read), ``solve_s`` and ``run_once_s``
     of both, and B1's time;
   - ``classes_50k_5k``: ``preempt_mix(50_000, 5_000)`` compressed against
     B1, bind for bind;
   - ``class_step_vs_plain``: B3 against ``class_step_plain`` (on the CPU)
     bit for bit on every ``ClassSolveState`` field, through the
     functional wrapper and through every in-place launch, on config 7's
     first segment, on ``_smoke_world()``, on a cut slot axis that
     overflows, and on both padded to ``CLASS_GLOBAL_CPAD`` slots (several
     a thread, the working state in global memory). Each is timed twice:
     B3 alone (``device_ms``: CUDA events around the raw launch of a
     ``ClassLaunch`` prepared beforehand, each launch on its own copy of
     the state) and the functional wrapper (``wrapper_ms``: the copy, the
     argument block, the launch). On config 7's segment also the
     profiler's device time of ``class_step_kernel`` and B3's latency bound,
     the probe ``csrc/class_floor.cu`` (built with the kernels, launched
     only here) at the segment's slots, B3's threads and the segment's
     iterations. The roofline bound counts the bytes the segment's data
     needs (``class_segment_bytes``); then ``class_step_floor``, B3's
     device time per iteration on ``_smoke_world()``'s 128 slots (the
     slope between a one-iteration and a whole segment; a reading of B3,
     not its bound), and the split of its fixed cost into the device's
     part and the wrapper's;
   - ``class_drills``, each on the card and again on the CPU, ending equal:
     (a) serial = fused = ``class_fused`` = ``class_sharded`` (``mesh:
     cuda:2``) over two cycles with arrivals; (b) ``solve.class_table``
     degrades, binds equal, counted; (c) the pod-affinity hybrid; (d) a
     streaming micro-cycle equal to one full cycle; (e) explain records
     under compression equal those without;
16. runs the port's analyzers on the card (``kube_batch_tpu_torch.analysis``),
   over solves and worlds the earlier steps already made:
   - ``trace_audit_50k_5k``: ``warm_cycles_50k_5k``'s cycles run inside
     the build sentinel with budget 0 (no nvcc, no library load); then one
     more warm cycle of its scheduler under
     ``torch.cuda.set_sync_debug_mode("warn")``, every sync attributed to a
     port ``file:line`` and counted, each site printed, and the phase fails
     on a site the port's ``analysis/trace-baseline.toml`` does not name;
     then B1 alone on the cycle's snapshot (upload done, up to the fetch)
     under ``"error"``. B4's launches in ``allocate_mesh_*`` (step 5) and
     B3's comparison launch (step 15) run under ``"error"`` too;
   - ``signature_drift``: KBT-P002 (no float64 field) and KBT-P005 (field
     names, shapes and dtypes) on the ``SolveState``s that ``allocate``
     (fused), ``allocate_mesh_*`` (sharded, m = 1 and 4) and
     ``classes_50k_5k`` (class, expanded to node space) returned, each
     against the entry state of the CPU plain version on the same world;
     no new solve;
   - ``interleave_card``: the interleaving model checker's
     ``dispatch_vs_next_solve`` scenario on the card (B1 in every
     schedule), every schedule clean and equal to the CPU explorer's
     (schedule count, trace ids, per-schedule binds);
17. prints one JSON line per phase, the ``{"kernels": [...]}`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Each kernel record carries its cluster size ``k`` (CTAs per launch), the
roofline bound (``bound_ms``: the larger of bytes over the HBM rate and
float32 operations over the float32 rate, with the operations counted from
the node-axis work these inputs need) and, for B1, the time per iteration
of every world it times and a latency bound (``latency_bound_ms``: the
world's dependent iterations times the kernel's time per iteration on a
128-node world, measured in the same run); B4's ``latency_bound_ms`` is
its iterations times B1's time per iteration on that world timed as B4
is (``raw_ms``: CUDA events around the library's launch alone) plus its
placing iterations times the exchange's latency between cards (0 on one
card; ``--cards`` measures it with csrc/mesh_floor.cu); B3's ``latency_bound_ms`` is
the latency probe's time on config 7's segment (``class_step_vs_plain``),
measured in the same run, beside its ``device_ms``, ``wrapper_ms``, the
profiler's device time, its registers and spills (``ptxas``) and its
slope at 128 slots (``slope_*``).

Any failed phase raises and exits non-zero. Without a CUDA device it exits
with code 2 before printing any result.

    python3 chip_smoke.py --cards

runs instead the sharded rung over every visible card, one shard each
(two or more cards): ``allocate(preempt_mix(50_000, 5_000),
mesh=make_mesh())`` (B4, one launch a card) against the fused rung on
cuda:0, and the fused rung on the last card against it too, and B4 over
the cards from a prefix of the jobs against its plain version on as many
CPU cards; then
``mesh_floor`` (csrc/mesh_floor.cu: a stamped record passed through peer
memory between two and between all the cards, the exchange's latency a
placing iteration, B4's bound, and a round of K = 4 records); B4 at K = 1
and K = 4 in turns over the cards at 50k x 5k with the round's split
(``b4_k4_preempt_mix_50k_5k_<m>cards``) and on config 7
(``multichip_b4_by_k_400k_40k``: ``uniform_pool(400_000, 40_000)``, K = 1
and 4 against B1 on cuda:0, with the split); then the multi-card deployment, the
twin of ``examples/scheduler-conf-tpu-multichip.yaml``
(``examples/scheduler-conf-torch-multichip.yaml``, ``mesh: auto``)
through the whole pipeline, in seven phases (``multichip_phases``), each
held to a reference on the fused rung on cuda:0 computed in the same run
and timed beside the same mesh with every shard on cuda:0 (three arms:
``reference``, ``cards``, ``one_card``): ``multichip_cycle_50k_5k`` (one
``run_once`` of the twin conf, with a fourth arm ``host_loop``: the same
mesh over the cards on the host loop over B2, B4's plain version at full
width), ``multichip_warm_cycles_50k_5k`` (the
arena's static slabs, one row a card, reused on every card in
cycle 2), ``multichip_pipelined_50k_5k`` (``KBT_PIPELINE``),
``multichip_explain_50k_1k`` (the records), ``multichip_classes_50k_5k``
(``KBT_CLASS_COMPRESS``: B3 on cuda:0 alone), ``multichip_ladder``
(``solve.sharded`` degrades the cycle to the fused rung on cuda:0) and
``multichip_trace_audit`` (the sync audit's sharded solve: no sync a
placing iteration, one barrier a card). Every record carries ``m``,
each card's name and power limit, ``run_once_s``, the sharded rung's
split, the host record reads per placing iteration (none on B4), the
launches by card and B4's device time by card. ``--rehearse CUT --cards`` runs those seven phases on the CPU on
``mesh: cpu:4``, the worlds divided by CUT.

    python3 chip_smoke.py --pipeline-uncut

runs only ``pipeline_fused_50k_1k`` uncut and ``pipeline_reclaim`` at
50,000 pods on the card: the uncut preempt walk and reclaim pass,
minutes of host work.

    python3 chip_smoke.py --federation

runs only the kernels' build and the federation's three phases (step 12).

    python3 chip_smoke.py --streaming

runs only the kernels' build and the streaming scheduler's three phases
(step 13).

    python3 chip_smoke.py --operator

runs only the kernels' build and the operator surfaces' four phases (step
14).

    python3 chip_smoke.py --classes

runs only the kernels' build and the class-compressed solve's four phases
(step 15).

    python3 chip_smoke.py --uploads

runs only ``upload_probe``: the host time of one upload to the card by
route (a plain copy, pinned staging, the tensor arena's miss and reuse) at
the class rung's shapes, with the card idle and with it busy.

    python3 chip_smoke.py --b4 [--cards]

runs only kernel B4's phases (``b4_only``): on one card its card tests,
``b4_by_k`` with its splits, B1 and B4 at 50k x 5k, and the round's split
at 50k x 5k and on config 7 over four cards of one solve on cuda:0; with
``--cards`` B4 over the cards at 50k x 5k and on config 7.

    python3 chip_smoke.py --ab-b4 DIR

times B4 at K = 4 over every card at 50k x 5k in the checkout at DIR (the
parent, unpacked with ``git archive``) against this one, DIR, this, this,
DIR, a process each (``ab_b4``).

    python3 chip_smoke.py --ab-warm DIR

runs instead ``warm_cycles_50k_5k`` of the checkout at DIR (the parent
commit, unpacked with ``git archive``) and of this one, in the order DIR,
this, this, DIR, each in a process of its own.

    python3 chip_smoke.py --rehearse CUT

needs no card: the pipeline phases (step 8), the fast paths' (step 9),
the ladder's and the trace's (step 10), the process's (step 11), the
federation's (step 12), the streaming scheduler's (step 13), the
operator surfaces' (step 14) and the class solve's (step 15, without
``class_step_vs_plain``) on the CPU,
every world's pod and node counts divided by CUT (the drills' small
world is not cut, and ``ha_failover_50k_5k`` kills its leader after a
tenth as many binds),
torch_allocate on the kernels' plain versions; the host actions' times
predict the card run's.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading
import time

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The data sheet's 67 TFLOP/s float32 (outside the tensor cores) counts an
# FMA as two operations. The kernel is built with -fmad=false and issues no
# FMA, so its peak is one float32 instruction per lane and clock: 33.5e12/s.
H100_FP32_OPS_PER_S = 67e12 / 2
# float32 operations (add, subtract, multiply, divide, compare, floor, abs:
# one each) the solve needs per node of the node axis and popped task:
# - each node whose fit has to be tested (statically compatible, with pod
#   room and free ports): per resource dim, idle + eps and releasing + eps,
#   and a compare against each;
# - each feasible node, scored: 2 adds (requested); per LeastRequested dim
#   2 compares, subtract, multiply, divide, floor; 2 compares and 2
#   divides (fractions); Balanced 2 compares, subtract, abs, multiply,
#   subtract; 2 multiplies and 2 adds (score sum); 1 compare (arg-max).
FIT_OPS_PER_DIM = 4
SCORE_OPS_PER_NODE = 29
B2_TIMED_CALLS = 200  # block-step launches per timing
CARD_TESTS = ["tests/test_torch_kernel.py", "tests/test_torch_block_step.py", "tests/test_torch_cycle_card.py",
              "tests/test_torch_explain.py", "tests/test_torch_class_step.py", "tests/test_torch_arena.py",
              "tests/test_torch_mesh_solve.py", "tests/test_torch_mesh_batched.py"]
AFFINITY_PODS = 36  # pods of scheduler_affinity's world with required pod (anti-)affinity
# size_floor's preempt_mix(pods, nodes) worlds: 100 to 102,400 pending x nodes
FLOOR_WORLDS = ((25, 4), (50, 8), (100, 16), (200, 32), (400, 64), (800, 128))
# pending pods of pipeline_reclaim's reclaim_world on 1,000 nodes, cut from
# 50,000 so that torch_preempt's walk over the starved tasks (each against
# every node; about two minutes uncut) is not run twice;
# ``--pipeline-uncut`` runs it at 50,000
RECLAIM_PODS = 38_500
# pipeline_fused_50k_1k's pods and nodes divided by this for the script's
# clock: torch_preempt's walk (each starved task against every node, about
# 110 s uncut) falls to about a quarter; ``--pipeline-uncut`` runs it uncut
PREEMPT_WALK_CUT = 2
# the process and federation phases' worlds (``server_50k_5k``,
# ``ha_failover_50k_5k``, ``federation_50k_5k``, and the scale-out on top of
# ``SCALEOUT_CUT``) divided by this for the script's clock: their host time
# swung by 150 s between two calls of one tree; each record's ``reduced``
# holds the uncut counts
PROCESS_CUT = 2


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One record on stdout, and its time since the script started on
    stderr (the phases' timeline)."""
    print(json.dumps(obj), flush=True)
    print(f"chip_smoke: {time.perf_counter() - _T0:.2f} s {obj.get('phase', '-')}", file=sys.stderr, flush=True)


def card_line(every: bool = False) -> str:
    """The first card's name and power limit as nvidia-smi gives them (with
    ``every``, each visible card's, joined by "; ")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return "; ".join(lines) if every else lines[0]


def ptxas_summary(log: str) -> list[dict]:
    """Per entry function in an ``nvcc -Xptxas=-v`` log: registers, spill
    bytes (stores, loads) and static shared memory bytes."""
    import re

    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append({"function": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def card_tests() -> dict:
    """The card tests of both kernels, in a subprocess; raises on any
    failure."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", "-m", "cuda", *CARD_TESTS],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    if run.returncode != 0:
        raise AssertionError(f"card tests failed ({run.returncode}):\n{run.stdout[-4000:]}\n{run.stderr[-2000:]}")
    return {"phase": "card_tests", "files": CARD_TESTS, "summary": tail, "s": time.perf_counter() - t0}


def encoded_arrays(cluster):
    """The entry point's solver input, for the comparisons."""
    from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
    from kube_batch_tpu_torch.solve import solver_arrays

    return arrays_from_numpy(solver_arrays(cluster)[1])


def kernel_vs_plain(name: str, a: dict, timed_runs: int = 1, state=None, raw_runs: int = 0) -> dict:
    """Run the kernel (card) and the plain version (CPU) on the same packed
    inputs, from ``state`` (default: the entry state); raise on any
    difference. With ``raw_runs``, also time that many launches as B4 is
    timed (``b1_raw_times``: CUDA events around the library's launch
    alone), each result equal to the wrapper's; their median after the
    first is ``raw_ms``. Returns the comparison record."""
    import torch

    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops.kernels import init_state

    packed = fs.pack(a, True, True)
    init = fs.pack_state(packed.dims, init_state(a, True, True) if state is None else state, a["job_queue"])

    t0 = time.perf_counter()
    plain = fs.PackedState(packed.dims, init.istate.clone(), init.fstate.clone())
    work = {"fit_nodes": 0, "scored_nodes": 0}
    fs.fused_solve_plain(packed, plain, work)
    plain_ms = (time.perf_counter() - t0) * 1e3

    dev = packed.to("cuda")
    geo = fs.solve_geometry(packed.dims)
    times = []
    for _ in range(timed_runs):
        st = fs.PackedState(packed.dims, init.istate.cuda(), init.fstate.cuda())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fs.fused_solve(dev, st)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    got_i, got_f = st.istate.cpu(), st.fstate.cpu()

    kv = fs.PackedState(packed.dims, got_i, got_f).views()
    pv = plain.views()
    for field in pv:
        if not torch.equal(kv[field], pv[field]):
            diff = (kv[field] != pv[field]).nonzero().flatten()[:5].tolist()
            raise AssertionError(
                f"{name}: kernel and plain differ in {field} at {diff}: "
                f"kernel {kv[field][diff].tolist()} plain {pv[field][diff].tolist()}"
            )
    if not torch.isfinite(got_f).all():
        raise AssertionError(f"{name}: non-finite float state")
    max_abs_err = float((got_f - plain.fstate).abs().max()) if got_f.numel() else 0.0
    d = packed.dims
    scal = kv["scal"]
    popped = int((kv["jptr"] - init.views()["jptr"]).sum())
    bytes_moved = 4 * (
        packed.istatic.numel() + packed.fstatic.numel()
        + 2 * (init.istate.numel() + init.fstate.numel())
    )
    ops = work["fit_nodes"] * FIT_OPS_PER_DIM * d.R + work["scored_nodes"] * SCORE_OPS_PER_NODE
    t_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    ms = times[-1] if timed_runs == 1 else statistics.median(times[1:])
    raw = {}
    if raw_runs:
        raw_times, raw_state = b1_raw_times(dev, init, raw_runs)
        if not (torch.equal(raw_state.istate.cpu(), got_i) and torch.equal(raw_state.fstate.cpu(), got_f)):
            raise AssertionError(f"{name}: the raw launch differs from the wrapper's")
        raw_ms = statistics.median(raw_times[1:]) if raw_runs > 1 else raw_times[0]
        raw = {"raw_ms": raw_ms, "raw_runs_ms": raw_times, "raw_ms_per_iteration": raw_ms / max(int(scal[0]), 1)}
    return {
        "world": name,
        "T": d.T, "N": d.N, "J": d.J, "Q": d.Q, "C": d.C, "R": d.R,
        "k": geo.shape.k, "smem_bytes": geo.smem_bytes, "rep_in_smem": geo.rep_in_smem,
        "iterations": int(scal[0]), "assigned": int(scal[1]), "popped": popped,
        "pipelined": int((kv["tkind"] == 2).sum()),
        "ms": ms, "ms_per_iteration": ms / max(int(scal[0]), 1),
        "first_ms": times[0],
        "plain_ms": plain_ms,
        "max_abs_err": max_abs_err,
        "bytes": bytes_moved, "ops": ops, **work,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "match": True, **raw,
    }


def b1_raw_times(packed, init, runs: int) -> tuple[list[float], object]:
    """B1 timed as MeshSolve times B4: CUDA events on cuda:0's current
    stream around the library's launch alone, none of the wrapper's checks
    and argument building inside them; each run from ``init`` (CPU), a
    synchronise after each. Comparison launches: no counter moves. Returns
    the times (ms) and the last state."""
    import torch

    from kube_batch_tpu_torch.ops import fused_solve as fs

    lib = fs._library.load()
    geo, args = fs._launch_args(packed.dims)
    for name, view in packed.views().items():
        setattr(args, name, view.data_ptr())
    stream = torch.cuda.current_stream(0)
    times, st = [], None
    for _ in range(runs):
        st = fs.PackedState(packed.dims, init.istate.cuda(), init.fstate.cuda())
        for name, view in st.views().items():
            setattr(args, name, view.data_ptr())
        scratch = None
        if not geo.rep_in_smem:
            scratch = torch.empty(geo.shape.k * geo.rep_words, dtype=torch.int32, device="cuda:0")
            args.scratch = scratch.data_ptr()
        fs._check_occupancy(0, args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        err = lib.kbt_fused_solve(ctypes.byref(args), 0, stream.cuda_stream)
        end.record(stream)
        if err != 0:
            raise AssertionError(f"B1's raw launch failed: {fs._library.error(err)}")
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del scratch
    return times, st


def jobs_prefix(a: dict, divisor: int = 16):
    """The entry state with only the first ``1 / divisor`` of the job rows
    active: a prefix of a full-width solve's work, for the comparisons
    whose plain run would take minutes of host CPU on the whole solve."""
    from kube_batch_tpu_torch.ops.kernels import init_state

    prefix = init_state(a, True, True)
    prefix = prefix._replace(job_active=prefix.job_active.clone())
    prefix.job_active[prefix.job_active.shape[0] // divisor :] = False
    return prefix


def check_binds(res) -> dict:
    """Host-side checks of the entry point's result: capacity per node
    (idle for allocated tasks, releasing for pipelined ones) and the gang
    barrier per job."""
    import numpy as np

    enc, st = res.encoded, res.state
    a = enc.arrays
    n = enc.n_tasks
    node = st.assigned_node[:n].numpy()
    kind = st.assigned_kind[:n].numpy()
    req = a["task_res"][:n].astype(np.float64)
    eps = a["eps"].astype(np.float64)
    for k, pool in ((1, a["node_idle"]), (2, a["node_rel"])):
        rows = kind == k
        load = np.zeros(pool.shape, np.float64)
        np.add.at(load, node[rows], req[rows])
        over = load > pool.astype(np.float64) + eps
        if over.any():
            bad = np.argwhere(over)[0]
            raise AssertionError(f"node {enc.node_names[bad[0]]} over capacity in dim {bad[1]} (kind {k})")
    bound_jobs = {}
    row_of = {f"{t.namespace}/{t.name}": i for i, t in enumerate(enc.tasks)}
    for key in res.binds:
        j = int(a["task_job"][row_of[key]])
        bound_jobs[j] = bound_jobs.get(j, 0) + 1
    for j, cnt in bound_jobs.items():
        ready = int(a["job_ready0"][j]) + cnt
        if ready < int(a["job_min"][j]) or int(st.ready_cnt[j]) < int(a["job_min"][j]):
            raise AssertionError(f"job row {j} bound below its gang minimum")
    return {"capacity_ok": True, "gang_ok": True, "bound_jobs": len(bound_jobs)}


def block_work(block, task) -> dict:
    """The least the block step must read and compute for these inputs,
    node by node as a test that stops at the first failing condition
    would: every node's compat word; for the statically compatible ones,
    the pod count and limit; for those with pod room, the port mask; for
    those (the fit-tested nodes) the scalar-map flags when the task asks
    for scalars, and R idle and R releasing values; for the scored nodes
    (the ones that fit), 2 used and 2 allocatable values and the affinity
    score. (The kernel issues all of a node's loads at once, so it reads
    more.) Returns the node counts and the bytes (each input once, plus
    the record written)."""
    import torch

    from kube_batch_tpu_torch.ops.block_step import RECORD

    R = block.idle.shape[0]
    req = torch.tensor(task.req[:R], dtype=torch.float32, device=block.idle.device)[:, None]
    eps = torch.tensor(task.eps[:R], dtype=torch.float32, device=block.idle.device)[:, None]
    compat = block.cnode[task.gid] != 0
    room = compat & (block.ntasks < block.nmax)
    base = room & ((block.nports & task.tports) == 0)
    fi = (req < block.idle + eps).all(0)
    fr = (req < block.rel + eps).all(0)
    if task.has_sc:
        fi, fr = fi & (block.nihs != 0), fr & (block.nrhs != 0)
    n = {"nodes": block.cnode.shape[1], "compat_nodes": int(compat.sum()), "room_nodes": int(room.sum()),
         "fit_nodes": int(base.sum()), "scored_nodes": int((base & (fi | fr)).sum())}
    words = (
        n["nodes"] + 2 * n["compat_nodes"] + n["room_nodes"]
        + n["fit_nodes"] * (2 * R + (2 if task.has_sc else 0))
        + n["scored_nodes"] * 5
    )
    return {**n, "bytes": 4 * (words + RECORD)}


def kernel_device_ms(fn, calls: int, name: str) -> float | None:
    """Mean device time of the kernels whose name holds ``name`` over
    ``calls`` calls of ``fn``, from the profiler's trace of the card; None
    when the trace holds no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key and e.count > 0]
    total = sum(e.device_time_total for e in events)  # microseconds
    count = sum(e.count for e in events)
    return total / count / 1e3 if count and total > 0 else None


def block_vs_plain(name: str, block, task, timed: bool = False) -> dict:
    """B2 on the card against its plain version on the CPU, on the same
    block and task; raises on any difference. With ``timed``: the time
    per call of back-to-back launches from CUDA events (``ms``, which
    holds the host's cost of each launch too), the plain version's from
    the host clock, the roofline bound, and the prepared step under
    ``"step"`` for ``time_b2_kernel``."""
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops.cluster import cluster_shape

    host = bs.Block(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in block.__dict__.items()})
    out = torch.zeros(bs.RECORD, dtype=torch.int32, device=block.idle.device)
    step = bs.BlockStep(block, out)
    launches = bs.block_step.launches
    got = bs.read_record(step(task).cpu())
    t0 = time.perf_counter()
    want = bs.block_step_plain(host, task)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError(f"{name}: block step kernel {got} != plain {want}")
    rec = {"case": name, "N": block.cnode.shape[1], "k": cluster_shape(block.cnode.shape[1]).k,
           "off": block.off, "gid": task.gid,
           "score": got[0], "index": got[1], "fits_idle": got[2], "max_abs_err": 0.0}
    if timed:
        for _ in range(10):
            step(task)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(B2_TIMED_CALLS):
            step(task)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / B2_TIMED_CALLS
        t0 = time.perf_counter()
        for _ in range(5):
            bs.block_step_plain(host, task)
        plain_ms = (time.perf_counter() - t0) * 1e3 / 5
        work = block_work(host, task)
        ops = work["fit_nodes"] * FIT_OPS_PER_DIM * block.idle.shape[0] + work["scored_nodes"] * SCORE_OPS_PER_NODE
        t_bytes = work["bytes"] / H100_HBM_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_OPS_PER_S * 1e3
        rec.update({
            "step": (step, task), "ms": ms, "plain_ms": plain_ms, **work, "ops": ops,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
    rec["plain_ms"] = plain_ms
    bs.block_step.launches = launches  # comparison launches are not the main path's
    return rec


def time_b2_kernel(rec: dict) -> None:
    """Set ``device_ms`` of a timed B2 record: the kernel's device time per
    launch from the profiler's trace (None where the trace has none)."""
    from kube_batch_tpu_torch.ops import block_step as bs

    step, task = rec.pop("step")
    launches = bs.block_step.launches
    kernel_ms = kernel_device_ms(lambda: step(task), B2_TIMED_CALLS, "block_step_kernel")
    bs.block_step.launches = launches  # timing launches are not the main path's
    rec["device_ms"] = kernel_ms


def b2_comparisons(arrays_5k, arrays_1k, arrays_ml) -> list[dict]:
    """B2 against its plain version on every listed input (see the module
    docstring, step 4). Returns the records; the timed ones (``step``
    set) are the main path's blocks at their entry state: 50k x 5k's
    5,120-node block (one shard) and 1,280-node blocks (four), and
    50k x 1k's 256-node blocks (four)."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops.fused_solve import FusedSolver
    from kube_batch_tpu_torch.ops.kernels import init_state
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver

    cuda = torch.device("cuda", 0)
    recs = []
    entry = init_state(arrays_5k, True, True)
    # a mid-solve node state: the fused kernel's solve of the first half
    # of the jobs
    half = entry._replace(job_active=entry.job_active.clone())
    half.job_active[half.job_active.shape[0] // 2 :] = False
    mid = FusedSolver(arrays_5k, True, True, device=cuda).solve(half)
    # the host loop keeps B2's blocks (B4, the default route, has none)
    one = ShardedBlockSolver(arrays_5k, [cuda], True, True, impl="host_loop")
    four = ShardedBlockSolver(arrays_5k, [cuda] * 4, True, True, impl="host_loop")
    for label, state in (("entry", entry), ("mid", mid)):
        one._upload(state)
        four._upload(state)
        for c, task in enumerate(one._tasks):
            timed = label == "entry" and c == 0
            recs.append(block_vs_plain(f"preempt_mix_50k_5k_{label}_class{c}", one.blocks[0], task, timed=timed))
            for k, blk in enumerate(four.blocks):
                recs.append(block_vs_plain(f"preempt_mix_50k_5k_{label}_class{c}_shard{k}of4", blk, task,
                                           timed=timed and k == 0))
    four_1k = ShardedBlockSolver(arrays_1k, [cuda] * 4, True, True, impl="host_loop")
    four_1k._upload(init_state(arrays_1k, True, True))
    for k, blk in enumerate(four_1k.blocks):
        recs.append(block_vs_plain(f"preempt_mix_50k_1k_entry_class0_shard{k}of4", blk, four_1k._tasks[0],
                                   timed=k == 0))
    # no candidate: nothing idle or releasing anywhere, for the task with
    # the largest cpu request (the encoder's pad rows request nothing, and
    # nothing fits within eps)
    blk = one.blocks[0]
    empty = bs.Block(**{**blk.__dict__, "idle": torch.zeros_like(blk.idle), "rel": torch.zeros_like(blk.rel)})
    rec = block_vs_plain("preempt_mix_50k_5k_no_candidate", empty, max(one._tasks, key=lambda t: t.req[0]))
    if rec["score"] != float("-inf") or rec["index"] != one.n_pad or rec["fits_idle"] != 0:
        raise AssertionError(f"no-candidate block gave {rec}")
    recs.append(rec)
    # scalar resources (GPU/TPU dims, has_sc) and host-port collisions: half
    # the nodes hold port bit 0 or 1, and each task asks for bit 0
    ml = ShardedBlockSolver(arrays_ml, [cuda], True, True, impl="host_loop")
    ml._upload(init_state(arrays_ml, True, True))
    rng = np.random.default_rng(0)
    ml.blocks[0].nports.copy_(torch.from_numpy(rng.integers(0, 3, ml.n_loc).astype(np.int32)))
    for c, task in enumerate(ml._tasks):
        recs.append(block_vs_plain(f"multi_tenant_ml_200_500_class{c}", ml.blocks[0], task))
        ported = bs.Task.from_buffer_copy(task)
        ported.tports = 1
        recs.append(block_vs_plain(f"multi_tenant_ml_200_500_class{c}_port_collision", ml.blocks[0], ported))
    if not any(t.has_sc for t in ml._tasks):
        raise AssertionError("multi_tenant_ml_200_500 has no task with scalar requests")
    return recs


EXCHANGE_KS = (1, 2, 4, 8)  # the batched exchange's depths timed beside K = 1


def exchange_phase(arrays: dict, want, device: str = "cuda", floor: dict | None = None) -> tuple[list[dict], int, int]:
    """The per-iteration and the K-deep batched exchange (step 6) on
    ``preempt_mix(2000, 40, seed=1)`` and four shards of the card, each held
    field for field against ``want``, the fused rung's SolveState. K = 1
    runs through the JAX package's GSPMD surface (``ShardedSolver``) with a
    tensor arena, on kernel B4; K = 4 (``exchange_k4``) through
    ``ShardedBlockSolver``, on B4 too (one card: its K = 1 loop, every
    placing iteration batched), also against B4's plain version at K = 4
    and B4 at K = 1; the host loop at K = 4 (``impl="host_loop"``, B2 once a
    shard and speculated placing iteration) as the comparison it stays.
    ``b4_by_k``: B4's device time on the same mesh at every K of
    EXCHANGE_KS, and over four cards of one solve on the card (one stream
    each: the batched exchange's rounds between cards, through the card's
    own memory), with the rounds and the speculated and committed placing
    iterations. Then ``sharded_solve_allocate`` on the same arena must
    reuse B4's three static slabs and give the fused rung's SolveResult.
    Returns the records, the main path's B4 launches (K = 1 through the
    surface, ``exchange_k4`` and ``sharded_solve_allocate``) and the host
    loop's B2 launches, each counted from zero."""
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.ops.encode_cache import TensorArena
    from kube_batch_tpu_torch.ops.kernels import result_of
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver
    from kube_batch_tpu_torch.parallel.sharded import ShardedSolver, sharded_solve_allocate

    on_card = device == "cuda"
    dev = torch.device(device, 0) if on_card else torch.device(device)
    mesh = [dev] * 4
    arena = TensorArena(dev)
    saved = bs.block_step.launches, ms.mesh_solve.launches
    recs, surface = [], 0
    for k in (1, 4):
        bs.block_step.launches = ms.mesh_solve.launches = 0
        if k == 1:
            solver = ShardedSolver(arrays, mesh, True, True, arena=arena).inner
        else:
            solver = ShardedBlockSolver(arrays, mesh, True, True, exchange_batch=k)
        t0 = time.perf_counter()
        got = solver.solve()
        solve_s = time.perf_counter() - t0
        same_state(f"preempt_mix_2k_40_seed1 m=4 K={k}", want, got)
        b2, b4 = bs.block_step.launches, ms.mesh_solve.launches
        if solver.impl != "mesh_kernel" or (on_card and (b2, b4) != (0, 1)):
            raise AssertionError(f"K={k}: {b2} B2 and {b4} B4 launches, on the {solver.impl}")
        if k > 1 and solver.batched_iters != solver.counts["placing_iterations"]:
            raise AssertionError(f"K={k} on one card: {solver.batched_iters} batched iterations of "
                                 f"{solver.counts['placing_iterations']} placing")
        surface += b4
        rec = {"phase": f"exchange_preempt_mix_2k_40_seed1_m4_k{k}", "s": solve_s,
               "surface": "ShardedSolver" if k == 1 else "ShardedBlockSolver", "impl": solver.impl,
               "batched_iters": solver.batched_iters, **solver.counts, "b2_launches": b2, "b4_launches": b4,
               "device_ms": solver._mesh.device_ms.get(0), "equal_to_fused": True}
        if k > 1:
            ms.mesh_solve.launches = 0
            plain = ms.MeshSolve(arrays, ["cpu"] * 4, True, True, cards=[0, 0, 0, 0], exchange_batch=k).solve()
            same_state(f"B4 at K={k} against its plain version", plain, got)
            rec.update(equal_to_plain=True, equal_to_k1=True)  # want is the K = 1 solve's state too
        recs.append(rec)
    # the host loop at K = 4: its own path, reached by name only
    bs.block_step.launches = ms.mesh_solve.launches = 0
    host = ShardedBlockSolver(arrays, mesh, True, True, exchange_batch=4, impl="host_loop")
    t0 = time.perf_counter()
    same_state("the host loop at K=4", want, host.solve())
    host_b2 = bs.block_step.launches
    recs.append({"phase": "host_loop_k4", "s": time.perf_counter() - t0, "impl": host.impl,
                 "batched_iters": host.batched_iters, **host.counts, "b2_launches": host_b2,
                 "b4_launches": ms.mesh_solve.launches, "equal_to_fused": True})
    recs.append(b4_by_k(arrays, want, dev, floor))
    before = arena.counters()
    ms.mesh_solve.launches = 0
    t0 = time.perf_counter()
    res = sharded_solve_allocate(arrays, mesh, True, True, arena=arena)
    solve_s = time.perf_counter() - t0
    surface_launches = ms.mesh_solve.launches
    surface += surface_launches
    bs.block_step.launches, ms.mesh_solve.launches = saved
    reused = {k: v - before[k] for k, v in arena.counters().items()}
    if reused["reuses"] != 3 or reused["full_uploads"]:
        raise AssertionError(f"sharded_solve_allocate did not reuse B4's three static slabs: {reused}")
    for field, x in zip(res._fields, res):
        if not torch.equal(x, getattr(result_of(want), field)):
            raise AssertionError(f"sharded_solve_allocate: {field} differs from the fused rung's")
    if on_card and surface < 3:
        raise AssertionError(f"the sharded surface and exchange_k4 launched B4 {surface} times, expected 3")
    recs.append({"phase": "sharded_surface", "world": "preempt_mix_2k_40_seed1", "m": 4, "s": solve_s,
                 "arena": reused, "launches": surface_launches, "equal_to_fused": True,
                 "arena_bytes_by_slab": arena.hbm_bytes_by_slab()})
    return recs, surface, host_b2


def b4_cards(arrays: dict, devs: list, k: int, timed: bool = False) -> tuple:
    """One B4 solve over ``len(devs)`` cards (a card a shard), card i on
    ``devs[i]`` (repeats allowed: several cards of one solve on one
    device): the cards of a CPU ``MeshSolve`` copied to their devices, an
    exchange buffer and the class keys each, a stream each (CUDA events
    around each launch); with ``timed`` the batched exchange's timed
    instantiation (``ms.launch_timed``). On the CPU the plain version.
    Returns the full-width SolveState, each card's kernel time (ms; none on
    the CPU), the rounds, each card's speculated placing iterations and,
    timed, each card's split (``ms.SPLIT_PARTS`` in ns, then the rounds)."""
    import torch

    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import mesh_solve as ms

    devs = [torch.device(d) for d in devs]
    m = len(devs)
    cpu = ms.MeshSolve(arrays, ["cpu"] * m, True, True, cards=list(range(m)), exchange_batch=k)
    full = cpu._load(None)
    cards, times, splits = cpu.cards, [], None
    if devs[0].type == "cuda":
        distinct = list(dict.fromkeys(devs))
        if len(distinct) > 1:
            ms.enable_peer_access(distinct)
        cards = [
            ms.Card(c.packed.to(d), c.gidx.to(d), fs.PackedState(c.state.dims, c.state.istate.to(d),
                                                                c.state.fstate.to(d)),
                    torch.zeros(ms.XBUF_WORDS, dtype=torch.int32, device=d), c.ckey.to(d))
            for c, d in zip(cpu.cards, devs)
        ]
        lib, prepared, index = ms._prepare(cards, 0, exchange_batch=k)
        prepared = [(args, scratch, torch.cuda.Stream(device=d)) for (args, scratch, _), d in zip(prepared, devs)]
        for d in distinct:
            torch.cuda.synchronize(d)
        if timed:
            splits = ms.launch_timed(lib, prepared, index, times)
        else:
            ms._launch_cards(lib, prepared, index, times)
        for d in distinct:
            torch.cuda.synchronize(d)
        splits = None if splits is None else [x.cpu().tolist() for x in splits]
    else:
        ms.mesh_solve(cards, exchange_batch=k)
    states = [fs.PackedState(c.state.dims, c.state.istate.cpu(), c.state.fstate.cpu()) for c in cards]
    for st, rows in zip(states, cpu._rows):
        ms.put_nodes(full.istate, st.istate, cpu.dims.istate(), st.dims.istate(), rows)
        ms.put_nodes(full.fstate, st.fstate, cpu.dims.fstate(), st.dims.fstate(), rows)
    ms._replicated_into(full, states[0])
    if any(int(st.istate[5]) for st in states):
        raise AssertionError(f"B4 over {m} cards on {devs} at K={k}: abort words "
                             f"{[int(st.istate[5]) for st in states]}")
    return (fs._state_of(full), [s.elapsed_time(e) for _, s, e in times], int(states[0].istate[6]),
            [int(st.istate[7]) for st in states], splits)


def b4_split(arrays: dict, devs: list, k: int, want, floor_ms_per_iter: float | None = None,
             round_us: float | None = None) -> dict:
    """The round's split: one solve of B4's timed instantiation at K = ``k``
    over the cards on ``devs`` (``b4_cards``), held to ``want`` field for
    field. Thread 0 of CTA 0 of each card stamps each part of every round
    on %globaltimer (ms.SPLIT_PARTS); the record gives each part's total
    (ms) and its time a round (µs) on every card, the kernel's time (CUDA
    events), the rounds and the rounds and speculated placing iterations
    per committed one. With B1's raw time an iteration (``floor_ms_per_iter``)
    and the round probe (``round_us``): the chain's own floor (the card's
    speculated placing iterations x the floor + rounds x the probe) and the
    existing bound (iterations x the floor + rounds x the probe). A
    comparison launch: no wrapper count moves."""
    from kube_batch_tpu_torch.ops import mesh_solve as ms

    state, times, rounds, speculated, splits = b4_cards(arrays, devs, k, timed=True)
    same_state(f"B4's timed instantiation at K={k} over {len(devs)} cards on {sorted(set(map(str, devs)))}",
               want, state)
    committed = int((state.ptr - arrays["job_start"]).sum())
    iterations = int(state.it)
    by_card = []
    for c, sp in enumerate(splits):
        ns, timed_rounds = sp[:-1], sp[-1]
        if timed_rounds != rounds:
            raise AssertionError(f"card {c} stamped {timed_rounds} rounds of {rounds}")
        by_card.append({
            "ms": {p: v * 1e-6 for p, v in zip(ms.SPLIT_PARTS, ns)},
            "us_per_round": {p: v * 1e-3 / max(rounds, 1) for p, v in zip(ms.SPLIT_PARTS, ns)},
            "stamped_ms": sum(ns) * 1e-6, "kernel_ms": times[c] if times else None,
        })
    rec = {"k": k, "cards": len(devs), "devices": [str(d) for d in devs], "rounds": rounds,
           "iterations": iterations, "committed": committed, "speculated_by_card": speculated,
           "rounds_per_committed": rounds / max(committed, 1),
           "speculated_per_committed": max(speculated) / max(committed, 1),
           "committed_per_round": committed / max(rounds, 1),
           "kernel_ms_by_card": times, "split_by_card": by_card, "equal_to_want": True}
    if floor_ms_per_iter is not None and round_us is not None:
        rec.update(floor_ms_per_iteration=floor_ms_per_iter, round_us=round_us,
                   chain_floor_ms=max(speculated) * floor_ms_per_iter + rounds * round_us * 1e-3,
                   bound_ms=iterations * floor_ms_per_iter + rounds * round_us * 1e-3)
        rec["share_of_bound"] = rec["bound_ms"] / max(times)
    return rec


def b4_by_k(arrays: dict, want, dev, floor: dict | None = None) -> dict:
    """``b4_by_k``: B4 at every K of EXCHANGE_KS on four shards of ``dev``
    (one card: one launch of its K = 1 loop) and over four cards of one
    solve on ``dev`` (the batched exchange between them), each held to
    ``want``; device times from CUDA events (the second of two solves on
    one card; the slowest card over cards). At K > 1 over the four cards
    also the round's split (``b4_split``; with ``floor``, B1's record on
    the same world, its derived readings against the round probe on one
    device). Comparison launches."""
    import torch

    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver

    saved = ms.mesh_solve.launches
    one_card, cards = {}, {}
    for k in EXCHANGE_KS:
        for _ in range(2):
            solver = ShardedBlockSolver(arrays, [dev] * 4, True, True, exchange_batch=k)
            same_state(f"B4 on one card at K={k}", want, solver.solve())
        one_card[k] = {"ms": solver._mesh.device_ms.get(0), "exchange_rounds": solver.counts["exchange_rounds"],
                       "placing_iterations": solver.counts["placing_iterations"],
                       "batched_iters": solver.batched_iters}
        state, times, rounds, speculated, _ = b4_cards(arrays, [dev] * 4, k)
        same_state(f"B4 over four cards on one device at K={k}", want, state)
        placing = int((state.ptr - arrays["job_start"]).sum())
        cards[k] = {"ms": max(times) if times else None, "ms_by_card": times, "exchange_rounds": rounds,
                    "speculated_by_card": speculated, "placing_iterations": placing,
                    "batched_iters": placing if k > 1 else 0, "iterations": int(state.it),
                    "rounds_per_committed": rounds / max(placing, 1)}
        if k > 1 and dev.type == "cuda":
            probe = mesh_floor_probe(4, k=k, on_one_device=True)
            cards[k]["split"] = b4_split(arrays, [dev] * 4, k, want,
                                         floor["raw_ms_per_iteration"] if floor else None, probe["exchange_us"])
            cards[k]["round_probe"] = probe
    ms.mesh_solve.launches = saved
    return {"phase": "b4_by_k", "world": "preempt_mix_2k_40_seed1", "device": str(dev), "one_card_m4": one_card,
            "four_cards_on_one_device": cards, "equal_to_fused": True}


def b4_bound(solver, ops: int, iterations: int, placing: int, floor_ms_per_iter: float,
             exchange_us: float = 0.0) -> dict:
    """B4's bounds on one solve: the roofline (each card's statics and gidx
    read once, its state read and written once, over the HBM rate; the
    node-axis operations B1's plain run counted on the same world, over the
    float32 rate) and the latency bound (the dependent iterations times
    B1's time per iteration on a 128-node world, timed as B4 is, around
    the launch alone, plus the placing iterations times the exchange's
    latency between cards, 0 on one card)."""
    words = sum(c.packed.istatic.numel() + c.packed.fstatic.numel() + c.gidx.numel()
                + 2 * (c.state.istate.numel() + c.state.fstate.numel()) for c in solver._mesh.cards)
    t_bytes = 4 * words / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return {"bytes": 4 * words, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "latency_bound_ms": iterations * floor_ms_per_iter + placing * exchange_us * 1e-3}


def mesh_solve_vs_plain(small: dict, big: dict, floor: dict) -> dict:
    """``mesh_solve_vs_plain``: kernel B4 on four shards of cuda:0 (one
    card, one launch) against the host loop with B2 on the card
    (``impl="host_loop"``) and B1, field for field, on ``small``
    (``preempt_mix(2000, 40, seed=1)``) and on ``big`` (``preempt_mix(50_000,
    5_000)``); on ``small`` also against its plain version on the CPU (the
    same grouping: four shards on one card) bit for bit, timed (B4 alone
    with CUDA events around its launch, ``ms``, the second of two solves;
    the plain run on the host clock); on ``big`` from ``jobs_prefix``'s
    state, against its plain version on four CPU cards (one a shard, as
    over four cards; the whole solve's plain run takes minutes). ``floor``
    is B1's record on ``small``: its raw time per iteration and its
    node-axis operations. Returns the record; its launches are B4's of the
    two compared solves. On ``big`` also the K-deep batched exchange's
    round split (``b4_split``) at BATCHED_K over four cards of one solve on
    cuda:0, held to B1."""
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver

    cuda0 = torch.device("cuda", 0)
    mesh = [cuda0] * 4
    rec = {"phase": "mesh_solve_vs_plain", "m": 4, "cards": 1}
    for label, a in (("preempt_mix_2k_40_seed1", small), ("preempt_mix_50k_5k", big)):
        b1 = fs.FusedSolver(a, True, True, device=cuda0).solve()
        torch.cuda.synchronize()
        b4, runs = None, []
        for _ in range(2):
            launches = ms.mesh_solve.launches
            solver = ShardedBlockSolver(a, mesh, True, True)
            t0 = time.perf_counter()
            b4 = solver.solve()
            runs.append({"s": time.perf_counter() - t0, "device_ms": solver._mesh.device_ms[0],
                         "launches": ms.mesh_solve.launches - launches})
        b2 = bs.block_step.launches
        host = ShardedBlockSolver(a, mesh, True, True, impl="host_loop")
        t0 = time.perf_counter()
        hl = host.solve()
        host_s = time.perf_counter() - t0
        b2 = bs.block_step.launches - b2
        same_state(f"{label}: B4 against B1", b1, b4)
        same_state(f"{label}: the host loop against B1", b1, hl)
        placing = solver.counts["placing_iterations"]
        if [r["launches"] for r in runs] != [1, 1] or b2 != 4 * placing:
            raise AssertionError(f"{label}: B4 launches {runs}, B2 {b2}; expected one a solve and 4 x {placing}")
        r = {"iterations": int(b4.it), "placing_iterations": placing, "runs": runs, "ms": runs[-1]["device_ms"],
             "ms_per_iteration": runs[-1]["device_ms"] / int(b4.it),
             "k": fs.solve_geometry(solver._mesh.cards[0].packed.dims).shape.k,
             "host_loop_s": host_s, "host_loop": host.timings, "b2_launches": b2, "equal_to_b1": True,
             "host_loop_equal_to_b1": True}
        if label == "preempt_mix_2k_40_seed1":
            t0 = time.perf_counter()
            plain = ms.MeshSolve(a, ["cpu"] * 4, True, True, cards=[0, 0, 0, 0]).solve()
            r["plain_ms"] = (time.perf_counter() - t0) * 1e3
            same_state(f"{label}: B4 against its plain version", plain, b4)
            r["max_abs_err"] = max(float((getattr(b4, f) - getattr(plain, f)).abs().max())
                                   for f in ("idle", "rel", "used", "job_alloc", "q_alloc"))
            r.update(b4_bound(solver, floor["ops"], r["iterations"], placing, floor["raw_ms_per_iteration"]))
        else:
            r["jobs_prefix"] = b4_vs_plain_prefix(a, mesh, [0, 1, 2, 3])
            # the batched exchange's round split at full width: four cards
            # of one solve on cuda:0, a stream each (comparison launches)
            probe = mesh_floor_probe(4, k=BATCHED_K, on_one_device=True)
            r["split_k4_four_cards_on_one_device"] = b4_split(a, [cuda0] * 4, BATCHED_K, b1,
                                                               floor["raw_ms_per_iteration"], probe["exchange_us"])
            r["round_probe_on_one_device"] = probe
        rec[label] = r
    return rec


def b4_vs_plain_prefix(a: dict, mesh: list, cards: list[int], exchange_batch: int = 1, divisor: int = 16) -> dict:
    """B4 at K = ``exchange_batch`` on ``mesh`` from ``jobs_prefix``'s state
    against its plain version on CPU cards grouped by ``cards``, field for
    field (with K > 1 also against B4 at K = 1 from the same state); the
    plain run's time on the host clock. Comparison launches."""
    import torch

    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver

    prefix = jobs_prefix(a, divisor)
    solver = ShardedBlockSolver(a, mesh, True, True, exchange_batch=exchange_batch)
    got = solver.solve(prefix)
    if exchange_batch > 1:
        same_state(f"B4 at K={exchange_batch} against K=1, jobs prefix",
                   ShardedBlockSolver(a, mesh, True, True).solve(prefix), got)
    t0 = time.perf_counter()
    plain = ms.MeshSolve(a, ["cpu"] * len(cards), True, True, cards=cards,
                         exchange_batch=exchange_batch).solve(prefix)
    plain_ms = (time.perf_counter() - t0) * 1e3
    same_state(f"B4 at K={exchange_batch} on {len(set(map(str, mesh)))} card(s) against its plain version on "
               f"{len(set(cards))} CPU cards, jobs prefix", plain, got)
    return {"k": exchange_batch, "jobs_active": int(prefix.job_active.sum()), "iterations": int(got.it),
            "placing_iterations": solver.counts["placing_iterations"],
            "exchange_rounds": solver.counts["exchange_rounds"], "speculated": solver.counts.get("speculated", 0),
            "device_ms": solver._mesh.device_ms,
            "plain_ms": plain_ms, "plain_cards": len(set(cards)), "equal_to_plain": True,
            "max_abs_err": max(float((getattr(got, f) - getattr(plain, f)).abs().max())
                               for f in ("idle", "rel", "used", "job_alloc", "q_alloc"))}


def same_state(name: str, want, got) -> None:
    """Every SolveState field equal: integers exactly, floats as values."""
    import torch

    for f in want._fields:
        x, y = getattr(want, f), getattr(got, f)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{name}: SolveState.{f} differs from the fused rung's")


def affinity_world():
    """``preempt_mix(10_000, 1_000)`` with the first task of every tenth
    job (36 jobs) labelled ``app: spread-<k % 3>``: three of every four
    repel their own label on the host (required anti-affinity), the fourth
    is drawn to the previous label (required affinity). Each of them is
    stepped on the host when it reaches the head of its job."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.apis.types import Affinity, PodAffinityTerm

    cluster = models.preempt_mix(10_000, 1_000)
    jobs = sorted((j for j in cluster.jobs.values() if j.name.startswith("job-")), key=lambda j: j.uid)
    for k, job in enumerate(jobs[::10][:AFFINITY_PODS]):
        pod = min(job.tasks.values(), key=lambda t: t.uid).pod
        pod.metadata.labels = {"app": f"spread-{k % 3}"}
        if k % 4 == 3:
            pod.affinity = Affinity(pod_affinity_required=[PodAffinityTerm(label_selector={"app": f"spread-{(k - 1) % 3}"})])
        else:
            pod.affinity = Affinity(pod_anti_affinity_required=[PodAffinityTerm(label_selector={"app": f"spread-{k % 3}"})])
    return cluster


def conf_file(mesh: str | None = None, actions: str | None = None, base: str = "scheduler-conf-torch.yaml",
              trace: str | None = None, **args) -> str:
    """examples/<base> (the cycle's conf by default), with ``actions`` in
    place of its pipeline, its ``trace:`` key, and ``mesh`` and
    torch_allocate's other ``args`` set when given, in place of the base's
    own where it names them (written beside the kernels' build, inside the
    checkout)."""
    import re
    import zlib

    from kube_batch_tpu_torch.ops import nvcc

    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "examples", base)
    if mesh is not None:
        args = {"mesh": mesh, **args}
    if actions is None and trace is None and not args:
        return path
    with open(path) as f:
        text = f.read()
    if trace is not None:
        text = f'trace: "{trace}"\n' + text
    if actions is not None:
        text = re.sub(r'^actions: ".*"$', f'actions: "{actions}"', text, count=1, flags=re.M)
    if args:
        head = "actionArguments:\n  torch_allocate:\n"
        if head not in text:
            text += head
        for k in args:
            text = re.sub(rf"^    {k}: .*\n", "", text, flags=re.M)
        text = text.replace(head, head + "".join(f"    {k}: {v}\n" for k, v in args.items()))
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    out = os.path.join(nvcc.BUILD_DIR, f"{base[:-5]}-{zlib.crc32(text.encode()):08x}.yaml")
    with open(out, "w") as f:
        f.write(text)
    return out


def size_floor() -> dict:
    """The serial allocate against the fused rung, ``run_once`` for
    ``run_once``, over small ``preempt_mix`` worlds around torch_allocate's
    size floor (pending tasks x nodes below which it runs serially): three
    cycles per arm and world, each over a fresh world, equal binds. Then
    one cycle per world with the example conf as it is, which must route
    serially exactly below ``DEFAULT_MIN_DEVICE_PAIRS`` and solve on the
    fused rung from it up."""
    import torch

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.actions.torch_allocate import DEFAULT_MIN_DEVICE_PAIRS
    from kube_batch_tpu_torch.api.types import TaskStatus
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    arms = {"serial": conf_file(actions="allocate, backfill"), "fused": conf_file(min_device_pairs=0),
            "default": conf_file()}

    def cycle(arm, pods, nodes):
        cache = FakeCache(models.preempt_mix(pods, nodes))
        sched = Scheduler(cache, arms[arm])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        act = sched.actions[0]
        tier = act.last_solver_tier if act.name == "torch_allocate" else "serial"
        return time.perf_counter() - t0, tier, dict(cache.binder.binds)

    rows = []
    for pods, nodes in FLOOR_WORLDS:
        world = models.preempt_mix(pods, nodes)
        pairs = sum(len(j.task_status_index.get(TaskStatus.PENDING, {})) for j in world.jobs.values()) * nodes
        times = {"serial": [], "fused": []}
        for _ in range(3):
            for arm in times:
                s, tier, binds = cycle(arm, pods, nodes)
                if tier != arm:
                    raise AssertionError(f"preempt_mix({pods}, {nodes}) on the {arm} arm solved by {tier!r}")
                if arm == "serial":
                    want = binds
                elif binds != want:
                    raise AssertionError(f"preempt_mix({pods}, {nodes}): the fused rung's binds differ from serial's")
                times[arm].append(s)
        s, tier, binds = cycle("default", pods, nodes)
        expect = "serial" if pairs < DEFAULT_MIN_DEVICE_PAIRS else "fused"
        if tier != expect or binds != want:
            raise AssertionError(f"preempt_mix({pods}, {nodes}), {pairs} pairs: the default conf solved on the "
                                 f"{tier!r} rung, expected {expect!r} below a floor of {DEFAULT_MIN_DEVICE_PAIRS}")
        rows.append({"pods": pods, "nodes": nodes, "pairs": pairs, "binds": len(want),
                     "serial_s": statistics.median(times["serial"]), "fused_s": statistics.median(times["fused"]),
                     "serial_runs_s": times["serial"], "fused_runs_s": times["fused"], "default_tier": tier,
                     "default_s": s})
    serial_wins = [r["pairs"] for r in rows if r["serial_s"] <= r["fused_s"]]
    return {"phase": "size_floor", "min_device_pairs": DEFAULT_MIN_DEVICE_PAIRS, "worlds": rows,
            "serial_wins_up_to_pairs": max(serial_wins, default=0),
            "fused_wins_from_pairs": min((r["pairs"] for r in rows if r["pairs"] > max(serial_wins, default=0)),
                                         default=None)}


def scheduler_cycle(phase: str, cluster, mesh: str | None, tier: str) -> tuple[dict, object, object]:
    """One ``run_once`` over ``FakeCache(cluster)``, the launch counters
    zeroed just before and read just after. Returns the phase record, the
    cache and the action."""
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    cache = FakeCache(cluster)
    sched = Scheduler(cache, conf_file(mesh))
    torch.cuda.synchronize()
    fs.fused_solve.launches = bs.block_step.launches = 0
    b4 = ms.mesh_solve.launches
    t0 = time.perf_counter()
    sched.run_once()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    b1, b2, b4 = fs.fused_solve.launches, bs.block_step.launches, ms.mesh_solve.launches - b4
    act = sched.actions[0]
    if act.name != "torch_allocate" or act.last_solver_tier != tier:
        raise AssertionError(f"{phase}: solved by {act.name} on the {act.last_solver_tier!r} rung, not {tier!r}")
    if "aborted" in sched.last_timings:
        raise AssertionError(f"{phase}: the cycle aborted: {sched.last_timings['aborted']}")
    rec = {
        "phase": phase, "mesh": mesh or "off", "tier": act.last_solver_tier, "run_once_s": wall_s,
        "cycle": dict(sched.last_timings), "torch_allocate": dict(act.last_timings),
        "b1_launches": b1, "b2_launches": b2, "b4_launches": b4,
        **({"counts": act.last_counts} if act.last_counts else {}), "binds": len(cache.binder.binds),
    }
    return rec, cache, act


def cycle_phases(clusters: dict, results: dict, mesh_launches: dict) -> tuple[list[str], dict]:
    """The three scheduling-cycle phases (module docstring, step 7). Each
    runs whatever the others did; returns the failures and the launches
    of each phase's main path."""
    failures, launches = [], {}

    def run(name, fn):
        run_phase(failures, name, fn)

    def fused():
        rec, cache, _ = scheduler_cycle("scheduler_fused", clusters["preempt_mix_50k_5k"], None, "fused")
        launches["scheduler_fused"] = (rec["b1_launches"], rec["b2_launches"])
        if (rec["b1_launches"], rec["b2_launches"], rec["b4_launches"]) != (1, 0, 0):
            raise AssertionError(f"{rec['b1_launches']} B1, {rec['b2_launches']} B2 and {rec['b4_launches']} B4 "
                                 "launches; expected 1, 0 and 0")
        if cache.binder.binds != results["preempt_mix_50k_5k"].binds:
            raise AssertionError("the cycle's binds differ from allocate()'s on the fused rung")
        emit({**rec, "equal_to_allocate": True})

    def sharded():
        rec, cache, _ = scheduler_cycle("scheduler_sharded", clusters["preempt_mix_50k_1k"], "cuda:4", "sharded")
        launches["scheduler_sharded"] = (rec["b1_launches"], rec["b2_launches"])
        want = mesh_launches[("preempt_mix_50k_1k", 4)]
        got = (rec["b1_launches"], rec["b2_launches"], rec["b4_launches"])
        if got != (0, 0, want) or rec["torch_allocate"].get("sharded_impl") != "mesh_kernel":
            raise AssertionError(f"{got} B1, B2 and B4 launches on {rec['torch_allocate'].get('sharded_impl')}; "
                                 f"expected (0, 0, {want}) on the mesh kernel")
        if cache.binder.binds != results["preempt_mix_50k_1k"].binds:
            raise AssertionError("the cycle's binds differ from the fused rung's")
        emit({**rec, "equal_to_fused": True})

    ends = {}

    def affinity(label, mesh, tier):
        def go():
            rec, cache, act = scheduler_cycle(f"scheduler_affinity_{label}", affinity_world(), mesh, tier)
            launches[f"scheduler_affinity_{label}"] = (rec["b1_launches"], rec["b2_launches"])
            steps = act.last_timings["host_steps"]
            if steps < 1:
                raise AssertionError("no host step: no affinity task reached the head of its job")
            if tier == "fused" and rec["b1_launches"] != steps + 1:
                raise AssertionError(f"{rec['b1_launches']} B1 launches for {steps} host steps")
            if tier == "sharded" and (rec["b2_launches"], rec["b4_launches"]) != (0, steps + 1):
                raise AssertionError(f"{rec['b2_launches']} B2 and {rec['b4_launches']} B4 launches for {steps} "
                                     "host steps on four shards of one card; expected 0 and one a segment")
            ends[label] = (steps, dict(cache.binder.binds), act.last_state)
            emit({**rec, "host_steps": steps, "affinity_pods": AFFINITY_PODS})
        return go

    run("scheduler_fused", fused)
    run("scheduler_sharded", sharded)
    run("scheduler_affinity_fused", affinity("fused", None, "fused"))
    run("scheduler_affinity_sharded", affinity("sharded", "cuda:4", "sharded"))

    def compare():
        if set(ends) != {"fused", "sharded"}:
            raise AssertionError("a rung of scheduler_affinity failed; nothing to compare")
        (fs_, fb, fst), (ss_, sb, sst) = ends["fused"], ends["sharded"]
        if fs_ != ss_:
            raise AssertionError(f"{fs_} host steps on the fused rung, {ss_} on the sharded rung")
        if fb != sb:
            raise AssertionError("the rungs' binds differ")
        same_state("scheduler_affinity sharded", fst, sst)
        emit({"phase": "scheduler_affinity", "host_steps": fs_, "binds": len(fb), "rungs_equal": True})

    run("scheduler_affinity", compare)
    run("size_floor", lambda: emit(size_floor()))
    return failures, launches


PIPELINE_CONF = "scheduler-conf-torch-pipeline.yaml"
# the serial-action pipeline pipeline_parity holds the twin conf against:
# the serial scans around the same device allocate, with nodeorder
SERIAL_SCANS_ACTIONS = "enqueue, reclaim, torch_allocate, backfill, preempt"
PARITY_SEEDS = 12


def reclaim_world(n_pods: int, n_nodes: int, seed: int = 0):
    """``preempt_mix(n_pods, n_nodes)`` with its residents moved into
    running gang jobs of a second queue, ``batch``, which holds more than
    its deserved share: the residents keep their shapes and nodes (one
    4-cpu, 8 GiB pod on every other node, none terminating), four to a
    gang of minimum one; ``batch`` has weight 1 against ``default``'s 9,
    so its deserved share is a tenth of the cluster while both queues ask
    for more. The pending work stays in ``default``: each of its jobs
    reclaims one resident for its first pending task (the first tier's
    gang and conformance plugins pass every resident, so, as in the
    reference's tiered Reclaimable, proportion's share is not consulted)."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.apis.types import PodPhase
    from kube_batch_tpu_torch.testing import (
        build_cluster,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )

    cluster = models.preempt_mix(n_pods, n_nodes, seed=seed)
    pods = [t.pod for job in cluster.jobs.values() for t in job.tasks.values() if not t.pod.node_name]
    pgs = [job.pod_group for job in cluster.jobs.values() if job.name.startswith("job-")]
    default, batch = build_queue("default", weight=9), build_queue("batch", weight=1)
    batch.metadata.creation_timestamp = default.metadata.creation_timestamp + 1.0
    nodes = [n.node for n in cluster.nodes.values()]
    for k, i in enumerate(range(0, n_nodes, 2)):
        gang = f"batch-{k // 4:05d}"
        if k % 4 == 0:
            pgs.append(build_pod_group(gang, queue="batch", min_member=1))
        pods.append(build_pod(
            name=f"resident-{i:05d}", group_name=gang, node_name=f"node-{i:05d}", phase=PodPhase.RUNNING,
            req=build_resource_list(cpu=4, memory="8192Mi"), priority=1,
        ))
    return build_cluster(pods, nodes, pgs, [default, batch])


def pipeline_cycle(phase: str, cluster, conf: str, device: str) -> tuple[dict, object, object]:
    """One ``run_once`` over ``FakeCache(cluster)`` with ``conf``, the
    launch counters zeroed just before and read just after; evictions
    counted by reason (``reclaim``, ``preempt``); every task's status and
    node read just before the session closes. Returns the phase record,
    the cache and the final task states."""
    import collections
    from types import SimpleNamespace

    import torch

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.testing import FakeCache

    cache = FakeCache(cluster)
    reasons = collections.Counter()
    cache_evict = cache.evict

    def evict(task, reason):
        reasons[reason] += 1
        cache_evict(task, reason)

    cache.evict = evict
    states = {}
    close = sched_mod.close_session

    def close_reading_states(ssn, discard=False):
        states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values() for t in j.tasks.values()})
        close(ssn, discard=discard)

    sched = sched_mod.Scheduler(cache, conf)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    sched_mod.close_session = close_reading_states
    fs.fused_solve.launches = bs.block_step.launches = 0
    try:
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            sched.run_once()
            sync()
            wall_s = time.perf_counter() - t0
    finally:
        sched_mod.close_session = close
    b1, b2 = fs.fused_solve.launches, bs.block_step.launches
    if "aborted" in sched.last_timings:
        raise AssertionError(f"{phase}: the cycle aborted: {sched.last_timings['aborted']}")
    acts = {a.name: a for a in sched.actions}
    alloc = acts["torch_allocate"]
    binds = dict(cache.binder.binds)
    rec = {
        "phase": phase, "run_once_s": wall_s, "cycle": dict(sched.last_timings),
        "actions": {name: dict(a.last_timings) for name, a in acts.items() if getattr(a, "last_timings", None)},
        "tier": alloc.last_solver_tier, "b1_launches": b1, "b2_launches": b2, "binds": len(binds),
        "evicts": len(cache.evictor.evicts), "evicts_by_reason": dict(reasons), **gc_clock.record(),
    }
    if alloc.last_encoded is not None:
        rows = {f"{t.namespace}/{t.name}" for t in alloc.last_encoded.tasks}
        rec["check_binds"] = check_binds(SimpleNamespace(
            encoded=alloc.last_encoded, state=alloc.last_state, binds={k: v for k, v in binds.items() if k in rows}))
    return rec, cache, states


def pipeline_phases(clusters: dict, results: dict, device: str = "cuda", cut: int = 1,
                    reclaim_pods: int = RECLAIM_PODS, walk_cut: int = PREEMPT_WALK_CUT,
                    only: tuple = ()) -> tuple[list[str], dict]:
    """The twin pipeline's phases (module docstring, step 8): the whole
    pipeline of examples/scheduler-conf-torch-pipeline.yaml through
    ``Scheduler.run_once``. ``device: cpu`` with ``cut`` > 1 is the CPU
    rehearsal (``--rehearse``): the worlds' pod and node counts divided by
    ``cut``, the kernels' plain versions, no launches to count.
    ``reclaim_pods`` is reclaim_world's pod count, ``walk_cut`` divides
    ``pipeline_fused_50k_1k``'s world further, ``only`` a subset of the
    phases to run. Returns the failures and the launches of each
    phase's main path."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch import testing as tt

    failures, launches = [], {}
    on_card = device == "cuda"
    twin = conf_file(base=PIPELINE_CONF, **({} if on_card else {"device": "cpu"}))

    def run(name, fn):
        run_phase(failures, name, fn)

    def world(name, nodes, pods=50_000, make=models.preempt_mix, div=cut):
        """A config-4 world of ``nodes`` nodes with ``pods`` of its 50,000
        pods, divided by ``div`` (``cut`` by default), and what was cut
        (``reduced``, empty when nothing was); an uncut main world is
        reused."""
        p, n = pods // div, nodes // div
        reduced = {key: [full, got] for key, full, got in (("pods", 50_000, p), ("nodes", nodes, n)) if full != got}
        if not reduced and name in clusters:
            return clusters[name], reduced
        return make(p, n), reduced

    def launched(rec, want_b1=None):
        launches[rec["phase"]] = (rec["b1_launches"], rec["b2_launches"])
        if not on_card:
            return
        if rec["b1_launches"] < 1 or rec["b2_launches"]:
            raise AssertionError(f"{rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches on the fused rung")
        if want_b1 is not None and rec["b1_launches"] != want_b1:
            raise AssertionError(f"{rec['b1_launches']} B1 launches; expected {want_b1}")

    def fused(name, nodes, want_b1=None, div=1):
        """The twin pipeline on a preempt_mix main world, divided by ``cut``
        times ``div``: its binds must equal allocate()'s on the same world
        (the main path's run where the world is uncut, else one on the
        card; single queue: reclaim has no victims and preempt only
        pipelines, so the allocate step decides the binds)."""
        from kube_batch_tpu_torch.solve import allocate

        cluster, reduced = world(name, nodes, div=cut * div)
        if not reduced and name in results:
            want = results[name].binds
        else:
            want = allocate(cluster, device="cuda").binds if on_card else None
        rec, cache, _ = pipeline_cycle(f"pipeline_fused_50k_{nodes // 1000}k", cluster, twin, device)
        launched(rec, want_b1)
        if rec["tier"] != "fused":
            raise AssertionError(f"torch_allocate solved on the {rec['tier']!r} rung")
        if want is not None and cache.binder.binds != want:
            raise AssertionError("the pipeline's binds differ from allocate()'s on the same world")
        return {**rec, "reduced": reduced, **({} if want is None else {"equal_to_allocate": True})}

    def fused_5k():
        emit(fused("preempt_mix_50k_5k", 5_000, want_b1=1))

    def fused_1k():
        rec = fused("preempt_mix_50k_1k", 1_000, div=walk_cut)
        if rec["evicts_by_reason"].get("preempt", 0) < 1:
            raise AssertionError("torch_preempt evicted nothing")
        emit(rec)

    def reclaim():
        cluster, reduced = world("reclaim_world_50k_1k", 1_000, reclaim_pods, make=reclaim_world)
        rec, cache, _ = pipeline_cycle("pipeline_reclaim", cluster, twin, device)
        launched(rec)
        if rec["evicts_by_reason"].get("reclaim", 0) < 1:
            raise AssertionError("torch_reclaim evicted nothing")
        emit({**rec, "reduced": reduced})

    def parity():
        serial = conf_file(actions=SERIAL_SCANS_ACTIONS, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
        twin0 = conf_file(base=PIPELINE_CONF, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
        worlds = [(f"{gen}_{seed}", lambda gen=gen, seed=seed: getattr(tt, gen)(seed))
                  for gen in ("gen_contended_cluster", "gen_contended_reclaim_cluster") for seed in range(PARITY_SEEDS)]
        worlds.append(("preempt_mix_2000_40_seed1", lambda: models.preempt_mix(2000, 40, seed=1)))
        binds = evicts = b1 = b2 = 0
        t0 = time.perf_counter()
        per_world = {}
        for name, make in worlds:
            want, want_cache, want_states = pipeline_cycle("serial_scans", make(), serial, device)
            got, got_cache, got_states = pipeline_cycle("twin", make(), twin0, device)
            if (got_states, got_cache.binder.binds, got_cache.evictor.evicts) != (
                    want_states, want_cache.binder.binds, want_cache.evictor.evicts):
                raise AssertionError(f"{name}: the twin conf's task states, binds or evicts differ from the serial scans'")
            binds += got["binds"]
            evicts += got["evicts"]
            b1 += got["b1_launches"] + want["b1_launches"]
            b2 += got["b2_launches"] + want["b2_launches"]
            per_world[name] = {"binds": got["binds"], "evicts": got["evicts"],
                               "twin_s": got["run_once_s"], "serial_scans_s": want["run_once_s"]}
        launches["pipeline_parity"] = (b1, b2)
        if on_card and (b1 < 1 or b2):
            raise AssertionError(f"{b1} B1 and {b2} B2 launches over the sweep")
        if per_world["preempt_mix_2000_40_seed1"]["evicts"] < 1:
            raise AssertionError("preempt_mix(2000, 40, seed=1) evicted nothing")
        if binds <= 10 or evicts <= 10:
            raise AssertionError(f"sweep too tame: {binds} binds, {evicts} evicts")
        emit({"phase": "pipeline_parity", "worlds": len(worlds), "binds": binds, "evicts": evicts,
              "b1_launches": b1, "b2_launches": b2, "s": time.perf_counter() - t0, "equal": True,
              "per_world": per_world})

    for name, fn in (("pipeline_fused_50k_5k", fused_5k), ("pipeline_fused_50k_1k", fused_1k),
                     ("pipeline_reclaim", reclaim), ("pipeline_parity", parity)):
        if not only or name in only:
            run(name, fn)
    return failures, launches


# -- the host fast paths: native hot loops and the encode cache ---------------

# encode_cache_100k_10k's world (the JAX package's own measurement of the
# layer) and warm_cycles_50k_5k's; the share of nodes and of pending pods
# replaced between encodes or cycles
CACHE_WORLD = (100_000, 10_000)
CYCLES_WORLD = (50_000, 5_000)
CHURN = 0.01


class GcClock:
    """Wall time the interpreter's cyclic collector spent, by generation,
    while installed (``gc.callbacks``): what a cycle's host layers lose to
    collections of the objects the snapshot and the replay allocate."""

    def __init__(self) -> None:
        self.s = [0.0, 0.0, 0.0]
        self.n = [0, 0, 0]
        self._t0 = 0.0

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.s[g] += time.perf_counter() - self._t0
            self.n[g] += 1

    def __enter__(self) -> "GcClock":
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        import gc

        gc.callbacks.remove(self._cb)

    def record(self) -> dict:
        return {"gc_s": sum(self.s), "gc_s_by_generation": self.s, "gc_collections": self.n}


def native_build() -> dict:
    """Build and load the port's native hot loops (native/build.py: g++
    against this interpreter's headers, into the package's _build
    directory). Raises when either fails: the run never carries on with
    the Python loops on the quiet."""
    from kube_batch_tpu_torch import native
    from kube_batch_tpu_torch.native import build

    t0 = time.perf_counter()
    path = build.ensure()
    build_s = time.perf_counter() - t0
    lib = native.load()
    return {"phase": "native_build", "s": build_s, "compiler": build.compiler_version(),
            "artifact": os.path.relpath(path, os.path.dirname(os.path.abspath(__file__))),
            "functions": sorted(n for n in dir(lib) if not n.startswith("_"))}


def relabel(node_info, key: str) -> None:
    """Replace the Node object under a NodeInfo by a relabelled copy (the
    watch-event shape)."""
    import dataclasses

    n = node_info.node
    labels = {**n.metadata.labels, key: "1"}
    node_info.set_node(dataclasses.replace(n, metadata=dataclasses.replace(n.metadata, labels=labels)))


def tolerate(task, key: str) -> None:
    """Replace a task's Pod object by a copy with one more toleration."""
    import dataclasses

    from kube_batch_tpu_torch.apis.types import Toleration

    task.pod = dataclasses.replace(
        task.pod, tolerations=[*task.pod.tolerations, Toleration(key=key, operator="Exists", effect="NoSchedule")])


def same_arrays(name: str, a, b) -> None:
    """Every array of two encodes byte-identical, and the same rows."""
    import numpy as np

    if set(a.arrays) != set(b.arrays) or [t.uid for t in a.tasks] != [t.uid for t in b.tasks]:
        raise AssertionError(f"{name}: the encodes' array sets or rows differ")
    for k, x in a.arrays.items():
        x, y = np.asarray(x), np.asarray(b.arrays[k])
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            raise AssertionError(f"{name}: arrays[{k!r}] differs from the cold encode's")


def encode_cache_phase(cut: int = 1) -> dict:
    """``encode_cache_100k_10k``: one session over ``preempt_mix(100_000,
    10_000)`` (pods and nodes divided by ``cut``), at float32 and float64:
    a cold encode, a warm one (nothing changed), one after replacing the
    Node object under 1% of nodes, one after replacing the Pod object of
    1% of pending tasks (reported through the dirty feed), and a cold one
    again. Every warm encode must be byte-identical to a cold encode of
    the same world."""
    import numpy as np

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch import plugins  # noqa: F401  (registers the plugins)
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.ops import encode_cache
    from kube_batch_tpu_torch.ops.encode import encode_session
    from kube_batch_tpu_torch.testing import FakeCache

    pods, nodes = CACHE_WORLD[0] // cut, CACHE_WORLD[1] // cut
    t0 = time.perf_counter()
    cache = FakeCache(models.preempt_mix(pods, nodes))
    with open(conf_file(base=PIPELINE_CONF)) as f:
        ssn = open_session(cache, parse_scheduler_conf(f.read()).tiers)
    setup_s = time.perf_counter() - t0
    ec = encode_cache.get()

    def encode(dtype):
        t = time.perf_counter()
        enc = encode_session(ssn.jobs, ssn.nodes, ssn.queues, drf=ssn.plugins.get("drf"),
                             proportion=ssn.plugins.get("proportion"), dtype=dtype, session=ssn)
        return time.perf_counter() - t, enc

    rec = {"phase": "encode_cache_100k_10k", "pods": pods, "nodes": nodes, "setup_s": setup_s}
    if cut > 1:
        rec["reduced"] = {"pods": [CACHE_WORLD[0], pods], "nodes": [CACHE_WORLD[1], nodes]}
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        ec.invalidate_all("chip_smoke")
        cold_s, cold = encode(dtype)
        warm_s, warm = encode(dtype)
        same_arrays(f"{name} warm", cold, warm)
        warm_fraction = warm.warm_fraction
        for node_name in sorted(ssn.nodes)[: max(int(nodes * CHURN), 1)]:
            relabel(ssn.nodes[node_name], f"churn-{name}")
        node_churn_s, node_churn = encode(dtype)
        node_churn_fraction = node_churn.warm_fraction
        ec.invalidate_all("chip_smoke")
        cold_nodes_s, cold_nodes = encode(dtype)
        same_arrays(f"{name} node churn", cold_nodes, node_churn)
        churned = cold_nodes.tasks[:: max(int(1 / CHURN), 1)]
        for task in churned:
            tolerate(task, f"churn-{name}")
            encode_cache.note_store_event("pods", task.uid, task.pod)
        pod_churn_s, pod_churn = encode(dtype)
        pod_churn_fraction = pod_churn.warm_fraction
        ec.invalidate_all("chip_smoke")
        cold_again_s, cold_again = encode(dtype)
        same_arrays(f"{name} pod churn", cold_again, pod_churn)
        if warm_fraction <= 0.5:
            raise AssertionError(f"{name}: the warm encode served only {warm_fraction:.2%} of its units warm")
        rec[name] = {
            "cold_s": cold_s, "warm_s": warm_s, "node_churn_s": node_churn_s, "cold_after_node_churn_s": cold_nodes_s,
            "pod_churn_s": pod_churn_s, "cold_again_s": cold_again_s, "warm_fraction": warm_fraction,
            "node_churn_warm_fraction": node_churn_fraction, "pod_churn_warm_fraction": pod_churn_fraction,
            "churned_nodes": max(int(nodes * CHURN), 1), "churned_pods": len(churned), "tasks": cold.n_tasks,
            "byte_identical": True,
        }
    close_session(ssn)
    return rec


def add_gang(cluster, name: str, size: int) -> None:
    """A new pending gang job of ``size`` pods (1 cpu, 1 GiB each) in the
    first queue."""
    from kube_batch_tpu_torch.testing import build_cluster, build_pod, build_pod_group, build_resource_list

    queue = sorted(cluster.queues.values(), key=lambda q: q.name)[0]
    gang = build_cluster(
        [build_pod(name=f"{name}-{i}", group_name=name, req=build_resource_list(cpu=1, memory="1Gi"))
         for i in range(size)],
        [], [build_pod_group(name, queue=queue.name, min_member=size)], [queue.queue],
    )
    cluster.jobs.update(gang.jobs)


def warm_cycles_phase(device: str = "cuda", cut: int = 1, keep: dict | None = None) -> tuple[dict, tuple[int, int]]:
    """``warm_cycles_50k_5k``: one Scheduler over the twin pipeline conf on
    ``FakeCache(preempt_mix(50_000, 5_000))`` (divided by ``cut``), three
    ``run_once``: cycle 1 cold, cycle 2 with nothing changed, and before
    cycle 3 the Node object under 1% of nodes replaced and one new gang
    job added. A second scheduler over a twin cache runs the same cycles
    with the encode cache and the native loops off; binds, evicts and task
    states must be equal cycle for cycle. The launch counters are zeroed
    just before each cycle of the fast scheduler and read just after; the
    cycles run inside the build sentinel with budget 0. ``keep`` (a dict)
    receives the fast scheduler as ``"sched"``. Returns the record and the
    B1 and B2 launches of those cycles."""
    import torch

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch import metrics, models, native
    from kube_batch_tpu_torch.analysis.trace.sentinel import CompileSentinel
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import encode_cache
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.testing import FakeCache

    on_card = device == "cuda"
    conf = conf_file(base=PIPELINE_CONF, **({} if on_card else {"device": "cpu"}))
    pods, nodes = CYCLES_WORLD[0] // cut, CYCLES_WORLD[1] // cut
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def arm(fast: bool):
        cache = FakeCache(models.preempt_mix(pods, nodes))
        return {"fast": fast, "cache": cache, "sched": sched_mod.Scheduler(cache, conf), "cycles": []}

    # raises past budget 0: a kernel built or loaded in a warm cycle
    with CompileSentinel("warm_cycles_50k_5k", budget=0) as sentinel:
        arms = [arm(True), arm(False)]
        close = sched_mod.close_session
        b1 = b2 = 0
        for cycle in range(3):
            if cycle == 2:
                for a in arms:
                    for node_name in sorted(a["cache"].cluster.nodes)[: max(int(nodes * CHURN), 1)]:
                        relabel(a["cache"].cluster.nodes[node_name], "churn")
                    add_gang(a["cache"].cluster, "warm-cycles-new-gang", 8)
            for a in arms:
                native.set_enabled(a["fast"])
                encode_cache.set_enabled(a["fast"])
                if a["fast"] and cycle == 0:
                    encode_cache.get().invalidate_all("chip_smoke")
                states = {}

                def close_reading_states(ssn, discard=False):
                    states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values()
                                   for t in j.tasks.values()})
                    close(ssn, discard=discard)

                native.reset_counts()
                faults_before = sum(metrics.fault_injections.samples().values())
                sync()
                sched_mod.close_session = close_reading_states
                fs.fused_solve.launches = bs.block_step.launches = 0
                try:
                    with GcClock() as gc_clock:
                        t0 = time.perf_counter()
                        a["sched"].run_once()
                        sync()
                        wall_s = time.perf_counter() - t0
                finally:
                    sched_mod.close_session = close
                launches = (fs.fused_solve.launches, bs.block_step.launches)
                if "aborted" in a["sched"].last_timings:
                    raise AssertionError(f"cycle {cycle + 1}: the cycle aborted: {a['sched'].last_timings['aborted']}")
                acts = {x.name: x for x in a["sched"].actions}
                t = {name: dict(getattr(acts[name], "last_timings", {}))
                     for name in ("torch_reclaim", "torch_allocate", "torch_preempt")}
                rec = {
                    "run_once_s": wall_s, "snapshot_s": a["sched"].last_timings.get("snapshot_s"),
                    "encode_s": {name: t[name].get("encode_s") for name in t},
                    "warm_fraction": {name: t[name].get("warm_fraction") for name in t},
                    "pack_s": t["torch_allocate"].get("pack_s"), "solve_s": t["torch_allocate"].get("solve_s"),
                    "fused_solve_s": t["torch_allocate"].get("fused_solve_s"),
                    "replay_s": t["torch_allocate"].get("replay_s"),
                    "actions_s": {k: v for k, v in a["sched"].last_timings.items() if k.endswith("_s")},
                    "native_calls": dict(native.calls), "native_fallbacks": dict(native.fallbacks),
                    "faults_fired": sum(metrics.fault_injections.samples().values()) - faults_before,
                    "tier": acts["torch_allocate"].last_solver_tier, "b1_launches": launches[0],
                    "b2_launches": launches[1], "binds": len(a["cache"].binder.binds),
                    "evicts": len(a["cache"].evictor.evicts), **gc_clock.record(),
                }
                arena = acts["torch_allocate"]._arena
                if a["fast"]:
                    rec["arena"] = {k[len("arena_"):]: v for k, v in t["torch_allocate"].items()
                                    if k.startswith("arena_")}
                    rec["arena_bytes_by_slab"] = arena.hbm_bytes_by_slab()
                    print(f"warm cycle {cycle + 1} arena: {rec['arena']} bytes {rec['arena_bytes_by_slab']}",
                          flush=True)
                    if rec["arena"].get("failures"):
                        raise AssertionError(f"cycle {cycle + 1}: the tensor arena failed: {rec['arena']}")
                elif arena is not None:
                    raise AssertionError(f"cycle {cycle + 1}: the arena ran with the encode cache off")
                a["cycles"].append((rec, states, dict(a["cache"].binder.binds), list(a["cache"].evictor.evicts)))
                if a["fast"]:
                    b1 += launches[0]
                    b2 += launches[1]
                    if on_card and (launches[0] < 1 or launches[1]):
                        raise AssertionError(f"cycle {cycle + 1}: {launches[0]} B1 and {launches[1]} B2 launches")
                    if rec["native_fallbacks"] or rec["faults_fired"]:
                        raise AssertionError(f"cycle {cycle + 1}: native fallbacks {rec['native_fallbacks']}, "
                                             f"{rec['faults_fired']} faults fired")
                    if not rec["native_calls"].get("bulk_assign"):
                        raise AssertionError(f"cycle {cycle + 1}: the replay did not run bulk_assign")
                elif rec["native_calls"]:
                    raise AssertionError(f"cycle {cycle + 1}: native calls with the native loops off")
    native.set_enabled(True)
    encode_cache.set_enabled(True)
    fast, slow = arms
    for cycle, (f, s) in enumerate(zip(fast["cycles"], slow["cycles"])):
        if f[1:] != s[1:]:
            raise AssertionError(f"cycle {cycle + 1}: the fast paths' task states, binds or evicts differ")
    cycle2 = fast["cycles"][1][0]["warm_fraction"]
    if not any(v for v in cycle2.values()):
        raise AssertionError(f"cycle 2 ran every encode cold: {cycle2}")
    arena2 = fast["cycles"][1][0]["arena"]
    if arena2.get("full_uploads") or arena2.get("row_updates") or arena2.get("reuses", 0) < 2:
        raise AssertionError(f"cycle 2 (nothing changed) did not reuse B1's statics: {arena2}")
    rec = {
        "phase": "warm_cycles_50k_5k", "pods": pods, "nodes": nodes, "churned_nodes": max(int(nodes * CHURN), 1),
        "new_gang": 8, "fast": [c[0] for c in fast["cycles"]], "off": [c[0] for c in slow["cycles"]],
        "equal_cycle_for_cycle": True, "b1_launches": b1, "b2_launches": b2,
        "binds_by_cycle": [len(c[2]) for c in fast["cycles"]],
        "kernel_builds": sentinel.builds, "library_loads": sentinel.loads,
    }
    if keep is not None:
        keep["sched"] = fast["sched"]
    if cut > 1:
        rec["reduced"] = {"pods": [CYCLES_WORLD[0], pods], "nodes": [CYCLES_WORLD[1], nodes]}
    return rec, (b1, b2)


def trace_audit_phase(sched, device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``trace_audit_50k_5k`` (step 16): one more warm cycle of
    ``warm_cycles_50k_5k``'s fast scheduler inside the build sentinel
    (budget 0), under the tensor arena's audit (KBT-P003 and P004 fail
    the phase; the arena's counters are printed). On the card that cycle, the sharded solve of the trace
    audit's warm world and B1 alone run through
    ``analysis.trace.audit_card_path`` (KBT-P001): every sync site is
    printed with its count, and the phase fails on a site the trace
    baseline does not name or on an entry's count past its max_count. On
    the CPU the cycle runs under the sentinel only. Returns the record and
    the cycle's B1 and B2 launches."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.analysis import baseline_path, load_baseline
    from kube_batch_tpu_torch.analysis import trace
    from kube_batch_tpu_torch.analysis.trace.sentinel import CompileSentinel
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.solve import solver_arrays

    label = "warm cycle 4 of warm_cycles_50k_5k"
    action = next(a for a in sched.actions if a.name == "torch_allocate")
    arena = action.arena_for(sched.cache, device)
    audited: dict = {}

    def cycle() -> None:  # the cycle under the arena audit (KBT-P003, P004)
        audited["records"], audited["summary"] = trace.arena_cycle_audit(sched.run_once, arena)

    t0 = time.perf_counter()
    fs.fused_solve.launches = bs.block_step.launches = 0
    with CompileSentinel("trace_audit_50k_5k", budget=0) as sentinel:
        if device == "cpu":
            cycle()
        else:
            arrays = solver_arrays(models.preempt_mix(*trace.WARM_WORLD, seed=1))[1]
            sites, audit = trace.audit_card_path(cycle, arrays)
    launches = (fs.fused_solve.launches, bs.block_step.launches)
    arena_findings = trace.check_arena(audited["records"], label)
    print(f"arena in {label}: {audited['summary']}", flush=True)
    if arena_findings:
        raise AssertionError("the tensor arena's audit:\n" + "\n".join(f.render() for f in arena_findings))
    rec = {"phase": "trace_audit_50k_5k", "device": device, "s": time.perf_counter() - t0,
           "kernel_builds": sentinel.builds, "library_loads": sentinel.loads,
           "b1_launches": launches[0], "b2_launches": launches[1], "arena": audited["summary"]}
    if device == "cpu":
        return {**rec, "p001": "not run: the sync audit needs a card"}, launches
    if launches[0] < 1 or launches[1]:
        raise AssertionError(f"the audited cycle launched B1 {launches[0]} and B2 {launches[1]} times")
    root = os.path.dirname(os.path.abspath(__file__))
    bl = load_baseline(baseline_path(root, "trace"), root)
    kept, suppressed, _ = trace.apply_trace_baseline(trace.check_syncs(sites, label), bl, sites)
    for site, n in audit["sites"].items():
        print(f"sync site {site}: {n}", flush=True)
    print(f"syncs in {label}: {audit['total']}; in the sharded solve of preempt_mix{trace.WARM_WORLD} "
          f"(m = {trace.MESH_AUDIT}): {audit['sharded_total']}", flush=True)
    if bl.errors or kept:
        raise AssertionError("sync sites with no trace-baseline entry or past its max_count:\n" + "\n".join(
            f.render() for f in [*bl.errors, *kept]))
    if audit["b4_launches_without_sync"] != 1 or audit["b2_launches_without_sync"]:
        raise AssertionError(f"the audited sharded solve made {audit['b4_launches_without_sync']} B4 launch groups "
                             f"and {audit['b2_launches_without_sync']} B2 launches; expected 1 and 0")
    return {**rec, **audit, "baselined_sites": len(suppressed)}, launches


def native_parity_phase(clusters: dict, results: dict, device: str = "cuda") -> dict:
    """``native_parity``: ``scheduler_fused`` at 50k x 5k and
    ``pipeline_parity``'s 25 worlds with the native loops on and off
    (equal binds, evicts and task states), and B1 on two worlds packed with
    native class numbering and with ``np.unique`` numbering: each
    bit-equal to its plain version, equal final states and binds."""
    import numpy as np

    from kube_batch_tpu_torch import models, native
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.solve import dispatch, solver_arrays

    on_card = device == "cuda"
    rec = {"phase": "native_parity"}
    try:
        if on_card:
            got = []
            for flag in (True, False):
                native.set_enabled(flag)
                r, cache, _ = scheduler_cycle(f"scheduler_fused_native_{'on' if flag else 'off'}",
                                              clusters["preempt_mix_50k_5k"], None, "fused")
                got.append((dict(cache.binder.binds), r["run_once_s"], r["torch_allocate"].get("replay_s")))
            if got[0][0] != got[1][0] or got[0][0] != results["preempt_mix_50k_5k"].binds:
                raise AssertionError("scheduler_fused: the binds differ with the native loops off")
            rec["scheduler_fused"] = {"binds": len(got[0][0]), "run_once_s": [got[0][1], got[1][1]],
                                      "replay_s": [got[0][2], got[1][2]], "equal": True}
        twin0 = conf_file(base=PIPELINE_CONF, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
        worlds = [(f"{gen}_{seed}", lambda gen=gen, seed=seed: getattr(tt, gen)(seed))
                  for gen in ("gen_contended_cluster", "gen_contended_reclaim_cluster") for seed in range(PARITY_SEEDS)]
        worlds.append(("preempt_mix_2000_40_seed1", lambda: models.preempt_mix(2000, 40, seed=1)))
        binds = evicts = 0
        for name, make in worlds:
            outs = []
            for flag in (True, False):
                native.set_enabled(flag)
                _, cache, states = pipeline_cycle("twin", make(), twin0, device)
                outs.append((states, cache.binder.binds, cache.evictor.evicts))
            if outs[0] != outs[1]:
                raise AssertionError(f"{name}: the twin pipeline differs with the native loops off")
            binds += len(outs[0][1])
            evicts += len(outs[0][2])
        rec["pipeline_parity"] = {"worlds": len(worlds), "binds": binds, "evicts": evicts, "equal": True}
        numbering = {}
        for name, make in (("preempt_mix_2k_40_seed1", lambda: models.preempt_mix(2000, 40, seed=1)),
                           ("multi_tenant_ml_200_500", lambda: models.multi_tenant_ml(200, 500))):
            a = encoded_arrays(make())
            n = {k: np.asarray(v) for k, v in a.items()}
            per = {}
            for flag in (True, False):
                native.set_enabled(flag)
                _, first, _ = fs._class_inverse(n)
                if on_card:
                    cmp = kernel_vs_plain(f"{name}_native_{flag}", a)
                    per[flag] = (first, cmp["iterations"], cmp["assigned"], cmp["ms"])
                else:
                    per[flag] = (first, None, None, None)
            cluster = make()
            states = {}
            for flag in (True, False):
                native.set_enabled(flag)
                solver = fs.FusedSolver(a, True, True, device="cuda" if on_card else "cpu")
                states[flag] = solver.solve()
            same_state(f"{name}: native and np.unique class numbering", states[True], states[False])
            enc, _ = solver_arrays(cluster)
            if dispatch(enc, states[True]) != dispatch(enc, states[False]):
                raise AssertionError(f"{name}: the binds differ between the class numberings")
            numbering[name] = {"classes": int(per[True][0].shape[0]),
                               "orders_differ": bool(not np.array_equal(per[True][0], per[False][0])),
                               "iterations": per[True][1], "assigned": per[True][2],
                               "ms_native": per[True][3], "ms_np_unique": per[False][3],
                               "binds": len(dispatch(enc, states[True])[0]), "equal": True}
        rec["class_numbering"] = numbering
    finally:
        native.set_enabled(True)
    return rec


def fast_path_phases(clusters: dict, results: dict, device: str = "cuda", cut: int = 1,
                     only: tuple = ()) -> tuple[list[str], dict]:
    """The host fast paths' phases: ``encode_cache_100k_10k``,
    ``warm_cycles_50k_5k``, ``trace_audit_50k_5k`` (step 16, on the warm
    cycles' scheduler) and ``native_parity`` (``native_build`` runs with
    the kernels' build). Each runs whatever the others did; returns
    the failures and the launches of the warm cycles' main path."""
    failures, launches = [], {}
    kept: dict = {}

    def run(name, fn):
        run_phase(failures, name, fn)

    def warm():
        rec, launches["warm_cycles_50k_5k"] = warm_cycles_phase(device, cut, keep=kept)
        emit(rec)

    def audit():
        rec, launches["trace_audit_50k_5k"] = trace_audit_phase(kept.pop("sched"), device)
        emit(rec)

    for name, fn in (("encode_cache_100k_10k", lambda: emit(encode_cache_phase(cut))),
                     ("warm_cycles_50k_5k", warm),
                     ("trace_audit_50k_5k", audit),
                     ("native_parity", lambda: emit(native_parity_phase(clusters, results, device)))):
        if (not only or name in only) and (name != "trace_audit_50k_5k" or "sched" in kept):
            run(name, fn)
    return failures, launches


def degradations() -> dict:
    """The process's counts of degradations so far: cycles the solver
    ladder ran below their rung, breaker transitions, fired fault points,
    abandoned native calls."""
    from kube_batch_tpu_torch import metrics, native

    return {
        "degraded_cycles": sum(metrics.degraded_cycles.samples().values()),
        "breaker_transitions": sum(metrics.breaker_transitions.samples().values()),
        "fault_injections": sum(metrics.fault_injections.samples().values()),
        "native_fallbacks": sum(native.fallbacks.values()),
    }


# kernel B4's launches by phase (``run_phase`` and the inline main paths):
# its wrapper counts where it launches, and a phase's count is the
# difference across it, so no phase's own zeroing of other counters moves it
B4_PATHS: dict[str, int] = {}
_PHASE_DEPTH = [0]


def run_phase(failures: list, name: str, fn, drill: bool = False) -> None:
    """Run one phase whatever the others did; a raise is a failure of the
    run, recorded in ``failures``. Outside the drills (which inject their
    faults and check their own degradations), a degradation during the
    phase is a failure too. B4's launches during the outermost phase go to
    ``B4_PATHS`` under its name."""
    from kube_batch_tpu_torch.ops import mesh_solve as ms

    before = degradations()
    b4 = ms.mesh_solve.launches
    _PHASE_DEPTH[0] += 1
    try:
        fn()
        grew = {k: v - before[k] for k, v in degradations().items() if v != before[k]}
        if grew and not drill:
            raise AssertionError(f"degraded with no fault injected: {grew}")
    except Exception as e:  # noqa: BLE001 - every phase runs; the script fails at the end
        failures.append(f"{name}: {type(e).__name__}: {e}")
        print(f"chip_smoke: {name} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
    finally:
        _PHASE_DEPTH[0] -= 1
        if _PHASE_DEPTH[0] == 0 and ms.mesh_solve.launches > b4:
            B4_PATHS[name] = B4_PATHS.get(name, 0) + ms.mesh_solve.launches - b4


def degradation_failures() -> list[str]:
    """The run's degradations before the drills: any is a failure."""
    from kube_batch_tpu_torch import metrics, native

    bad = []
    if native.fallbacks:
        bad.append(f"native fallbacks: {dict(native.fallbacks)}")
    for name in ("fault_injections", "degraded_cycles", "breaker_transitions"):
        got = {str(dict(k)): v for k, v in getattr(metrics, name).samples().items() if v}
        if got:
            bad.append(f"{name}: {got}")
    return bad


# -- the solver ladder under faults, and the cycle under trace ----------------

DRILL_WORLD = (2000, 40, 1)  # preempt_mix(2000, 40, seed=1)
DRILL_RESET_S = 5.0  # the drills' breaker backoff, skipped on the drills' clock


class DrillClock:
    """The drill ladder's clock: the monotonic clock plus an offset that a
    drill advances past a backoff instead of sleeping through it."""

    def __init__(self) -> None:
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset


def pg_phases(cluster) -> dict:
    """Each PodGroup's phase and running, failed and succeeded counts."""
    return {uid: (j.pod_group.status.phase.value, j.pod_group.status.running, j.pod_group.status.failed,
                  j.pod_group.status.succeeded) for uid, j in cluster.jobs.items() if j.pod_group is not None}


def drill_cycle(sched, cluster, device: str) -> dict:
    """One ``sched.run_once()`` over a fresh ``FakeCache(cluster)``, the
    launch counters zeroed just before and read just after; every task's
    state read just before the session closes; the cycle's binds, evicts,
    torch_allocate's rung and serial reason, and its degradations."""
    import torch

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.testing import FakeCache

    sched.cache = FakeCache(cluster)
    states = {}
    close = sched_mod.close_session

    def close_reading_states(ssn, discard=False):
        states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values() for t in j.tasks.values()})
        close(ssn, discard=discard)

    from kube_batch_tpu_torch.ops import mesh_solve as ms

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    before = degradations()
    sync()
    sched_mod.close_session = close_reading_states
    fs.fused_solve.launches = bs.block_step.launches = 0
    b4 = ms.mesh_solve.launches
    try:
        t0 = time.perf_counter()
        sched.run_once()
        sync()
        wall_s = time.perf_counter() - t0
    finally:
        sched_mod.close_session = close
    b1, b2, b4 = fs.fused_solve.launches, bs.block_step.launches, ms.mesh_solve.launches - b4
    alloc = next(a for a in sched.actions if a.name == "torch_allocate")
    return {
        "run_once_s": wall_s, "tier": alloc.last_solver_tier, "reason": alloc.last_timings.get("serial_reason"),
        "aborted": sched.last_timings.get("aborted"), "b1_launches": b1, "b2_launches": b2, "b4_launches": b4,
        "degradations": {k: v - before[k] for k, v in degradations().items() if v != before[k]},
        "binds": dict(sched.cache.binder.binds), "evicts": list(sched.cache.evictor.evicts), "states": states,
    }


def ladder_drills(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``ladder_drills``: the twin pipeline's Scheduler over
    ``preempt_mix(2000, 40, seed=1)`` (``min_device_pairs: 0``), each drill
    under a fresh solver ladder (threshold 3, a backoff of DRILL_RESET_S on
    a clock the drill advances), the process ladder restored after. Every
    cycle's binds and task states equal an undisturbed fused cycle's on the
    same world:

    (a) ``solve.fused`` once: a serial cycle (``solve_failed``), B1 ran and
        its result was not used;
    (b) three failing cycles open the ``fused`` breaker; the next cycle is
        serial (``breaker_open``) with no launch; after the backoff the
        probe cycle launches B1 once and closes it: closed -> open ->
        half_open -> closed;
    (c) ``mesh: <device>:4`` with ``solve.sharded`` once: B4 launches, then
        the fused rung resumes in the same cycle with one B1 launch;
    (d) ``solve.nan``: serial (``nonfinite``), no launch;
    (e) ``cycle.overrun``: an aborted cycle with no bind and no evict,
        PodGroup phases as before; the next cycle binds what an
        undisturbed cycle binds;
    (f) a soft deadline of 1 us for three cycles: on ``mesh:
        <device>:4`` the ``sharded`` tier trips and the next cycle solves
        on the fused rung; on the fused rung the card's cycles are counted
        as soft overruns and stay on the card (the rung below is the CPU),
        while on the CPU (``--rehearse``) the ``fused`` tier trips and the
        next cycle is serial;
    (g) ``python -m kube_batch_tpu_torch.faults.smoke`` on the device, in
        a process of its own: its five drills pass.

    Returns the record and the B1 and B2 launches of its cycles."""
    from kube_batch_tpu_torch import faults, metrics, models
    from kube_batch_tpu_torch.scheduler import Scheduler

    on_card = device == "cuda"
    pods, nodes, seed = DRILL_WORLD
    conf = conf_file(base=PIPELINE_CONF, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
    mesh_conf = conf_file(base=PIPELINE_CONF, min_device_pairs=0, mesh=f"{device}:4",
                          **({} if on_card else {"device": "cpu"}))

    def world():
        return models.preempt_mix(pods, nodes, seed=seed)

    launches = [0, 0]
    cycles: dict[str, list] = {}
    process_ladder = faults.solver_ladder

    def cycle(drill, sched, expect_tier, expect_reason=None, b1=None, b2=0, cluster=None):
        rec = drill_cycle(sched, cluster if cluster is not None else world(), device)
        launches[0] += rec["b1_launches"]
        launches[1] += rec["b2_launches"]
        cycles.setdefault(drill, []).append({k: v for k, v in rec.items() if k not in ("binds", "evicts", "states")})
        if rec["aborted"] is None and (rec["tier"], rec["reason"]) != (expect_tier, expect_reason):
            raise AssertionError(f"({drill}): solved on {rec['tier']!r} ({rec['reason']}), expected "
                                 f"{expect_tier!r} ({expect_reason})")
        if on_card and b1 is not None and (rec["b1_launches"] != b1 or b2 is not None and rec["b2_launches"] != b2):
            raise AssertionError(f"({drill}): {rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches, "
                                 f"expected {b1} and {b2}")
        if rec["degradations"].get("native_fallbacks"):
            raise AssertionError(f"({drill}): native fallbacks {rec['degradations']}")
        return rec

    def same_as_clean(drill, rec):
        if (rec["binds"], rec["evicts"], rec["states"]) != (clean["binds"], clean["evicts"], clean["states"]):
            raise AssertionError(f"({drill}): binds, evicts or task states differ from the undisturbed cycle's")

    def fresh(drill):
        faults.registry.reset()
        clock = DrillClock()
        ladder = faults.DegradationLadder(("sharded", "fused", "serial"), failure_threshold=3,
                                          reset_timeout=DRILL_RESET_S, clock=clock)
        history = []
        for b in ladder.breakers.values():
            real = b._transition

            def transition(to, b=b, real=real):
                history.append((b.name, b.state, to))
                real(to)

            b._transition = transition
        faults.set_solver_ladder(ladder)
        return ladder, clock, history

    rec = {"phase": "ladder_drills", "world": f"preempt_mix({pods}, {nodes}, seed={seed})",
           "breaker": {"failure_threshold": 3, "reset_timeout_s": DRILL_RESET_S}}
    try:
        fresh("clean")
        clean = cycle("clean", Scheduler(None, conf), "fused", b1=1)
        if not clean["binds"]:
            raise AssertionError("the undisturbed cycle bound nothing")

        ladder, _, history = fresh("a")
        faults.registry.arm("solve.fused", count=1)
        same_as_clean("a", cycle("a", Scheduler(None, conf), "serial", "solve_failed", b1=1))
        rec["a"] = {"history": history, "fused_failures": ladder.breakers["fused"].failures}
        if ladder.breakers["fused"].failures != 1 or history:
            raise AssertionError(f"(a): fused breaker {ladder.breakers['fused'].failures} failures, {history}")

        ladder, clock, history = fresh("b")
        faults.registry.arm("solve.fused", count=3)
        for _ in range(3):
            same_as_clean("b", cycle("b", Scheduler(None, conf), "serial", "solve_failed", b1=1))
        if ladder.state("fused") != "open":
            raise AssertionError(f"(b): three failures left the fused breaker {ladder.state('fused')}")
        same_as_clean("b", cycle("b", Scheduler(None, conf), "serial", "breaker_open", b1=0))
        clock.offset += DRILL_RESET_S
        same_as_clean("b", cycle("b", Scheduler(None, conf), "fused", b1=1))
        want = [("fused", "closed", "open"), ("fused", "open", "half_open"), ("fused", "half_open", "closed")]
        rec["b"] = {"history": history}
        if history != want:
            raise AssertionError(f"(b): breaker history {history}, expected {want}")

        ladder, _, history = fresh("c")
        faults.registry.arm("solve.sharded", count=1)
        got = cycle("c", Scheduler(None, mesh_conf), "fused", b1=1, b2=None)
        same_as_clean("c", got)
        if on_card and (got["b4_launches"] < 1 or got["b2_launches"]):
            raise AssertionError(f"(c): the sharded rung launched B4 {got['b4_launches']} and B2 "
                                 f"{got['b2_launches']} times before it failed; expected B4 and no B2")
        rec["c"] = {"history": history, "b4_launches": got["b4_launches"], "b1_launches": got["b1_launches"]}
        if ladder.breakers["sharded"].failures != 1 or history:
            raise AssertionError(f"(c): sharded breaker {ladder.breakers['sharded'].failures} failures, {history}")

        ladder, _, history = fresh("d")
        faults.registry.arm("solve.nan", count=1)
        same_as_clean("d", cycle("d", Scheduler(None, conf), "serial", "nonfinite: w_least", b1=0))
        rec["d"] = {"history": history}

        fresh("e")
        sched = Scheduler(None, conf)
        cluster = world()
        phases = pg_phases(cluster)
        faults.registry.arm("cycle.overrun", count=1)
        got = cycle("e", sched, None, cluster=cluster)
        if "dispatch barrier" not in (got["aborted"] or "") or got["binds"] or got["evicts"]:
            raise AssertionError(f"(e): the overrun did not abort before any bind: {got['aborted']}, "
                                 f"{len(got['binds'])} binds, {len(got['evicts'])} evicts")
        if pg_phases(cluster) != phases:
            raise AssertionError("(e): the aborted cycle changed PodGroup statuses")
        same_as_clean("e", cycle("e", sched, "fused", b1=1, cluster=cluster))
        rec["e"] = {"aborted": got["aborted"]}

        ladder, _, history = fresh("f")
        sched = Scheduler(None, mesh_conf, soft_deadline_s=1e-6)
        for _ in range(3):
            same_as_clean("f", cycle("f", sched, "sharded", b1=0, b2=None))
        if ladder.state("sharded") != "open":
            raise AssertionError(f"(f): three soft overruns left the sharded breaker {ladder.state('sharded')}")
        same_as_clean("f", cycle("f", sched, "fused", b1=1))
        rec["f"] = {"sharded_history": history}
        ladder, _, history = fresh("f")
        sched = Scheduler(None, conf, soft_deadline_s=1e-6)
        soft = {"kind": "soft"}
        overruns = metrics.cycle_overruns.value(soft)
        for _ in range(3):
            same_as_clean("f", cycle("f", sched, "fused", b1=1))
        if on_card:
            same_as_clean("f", cycle("f", sched, "fused", b1=1))
            if ladder.state("fused") != "closed" or history:
                raise AssertionError(f"(f): soft overruns on the card moved the fused breaker: {history}")
        else:
            if ladder.state("fused") != "open":
                raise AssertionError(f"(f): three soft overruns left the fused breaker {ladder.state('fused')}")
            same_as_clean("f", cycle("f", sched, "serial", "breaker_open", b1=0))
        rec["f"]["fused_history"] = history
        rec["f"]["fused_soft_overruns"] = metrics.cycle_overruns.value(soft) - overruns

        faults.registry.reset()
        faults.set_solver_ladder(process_ladder)
        smoke = subprocess.run([sys.executable, "-m", "kube_batch_tpu_torch.faults.smoke", "--device", device],
                               cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                               timeout=300)
        rec["g"] = {"returncode": smoke.returncode,
                    "lines": [line for line in smoke.stdout.splitlines() if line.startswith("chaos smoke")]}
        if smoke.returncode != 0:
            raise AssertionError(f"(g): the fault smoke exited {smoke.returncode}: {smoke.stdout[-2000:]} "
                                 f"{smoke.stderr[-2000:]}")
    finally:
        faults.registry.reset()
        faults.set_solver_ladder(process_ladder)
    rec["cycles"] = cycles
    rec["binds"], rec["evicts"] = len(clean["binds"]), len(clean["evicts"])
    rec["b1_launches"], rec["b2_launches"] = launches
    return rec, tuple(launches)


def overrun_phase(clusters: dict, results: dict, device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``overrun_50k_5k``: drill (e) at full width, the twin pipeline on
    ``preempt_mix(50_000, 5_000)``: ``cycle.overrun`` aborts the first
    cycle at the dispatch barrier, after B1 ran and the replay was done,
    and leaves the cache unchanged (no bind, no evict, PodGroup phases as
    before); the second cycle's binds equal ``allocate``'s. Two cycles."""
    from kube_batch_tpu_torch import faults, models
    from kube_batch_tpu_torch.scheduler import Scheduler

    on_card = device == "cuda"
    pods, nodes = CYCLES_WORLD[0] // cut, CYCLES_WORLD[1] // cut
    cluster = clusters.get("preempt_mix_50k_5k") if cut == 1 else None
    cluster = cluster if cluster is not None else models.preempt_mix(pods, nodes)
    sched = Scheduler(None, conf_file(base=PIPELINE_CONF, **({} if on_card else {"device": "cpu"})))
    phases = pg_phases(cluster)
    faults.registry.reset()
    faults.registry.arm("cycle.overrun", count=1)
    try:
        first = drill_cycle(sched, cluster, device)
    finally:
        faults.registry.reset()
    if "dispatch barrier" not in (first["aborted"] or "") or first["binds"] or first["evicts"]:
        raise AssertionError(f"the overrun did not abort before any bind: {first['aborted']}")
    if pg_phases(cluster) != phases:
        raise AssertionError("the aborted cycle changed PodGroup statuses")
    second = drill_cycle(sched, cluster, device)
    if second["aborted"] or second["tier"] != "fused":
        raise AssertionError(f"the second cycle: {second['aborted']}, on the {second['tier']!r} rung")
    if cut == 1 and second["binds"] != results["preempt_mix_50k_5k"].binds:
        raise AssertionError("the second cycle's binds differ from allocate()'s")
    if on_card and (first["b1_launches"], second["b1_launches"]) != (1, 1):
        raise AssertionError(f"{first['b1_launches']} and {second['b1_launches']} B1 launches; expected 1 and 1")
    rec = {"phase": "overrun_50k_5k", "pods": pods, "nodes": nodes,
           "aborted": first["aborted"], "aborted_run_once_s": first["run_once_s"],
           "next_run_once_s": second["run_once_s"], "binds": len(second["binds"]),
           "degradations": first["degradations"],
           "b1_launches": first["b1_launches"] + second["b1_launches"],
           "b2_launches": first["b2_launches"] + second["b2_launches"]}
    if cut > 1:
        rec["reduced"] = {"pods": [CYCLES_WORLD[0], pods], "nodes": [CYCLES_WORLD[1], nodes]}
    else:
        rec["equal_to_allocate"] = True
    return rec, (rec["b1_launches"], rec["b2_launches"])


def exposition_values(text: str) -> dict:
    """The exposition's samples, ``name{labels}`` -> value."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


TRACED_SPANS = ("cycle", "snapshot", "encode", "solve", "gang.assign", "commit")
SPAN_COST_SPANS = 10_000  # spans timed for the instrumentation's own cost
WARM_ROUNDS = 1  # rounds of traced, untraced, untraced, traced warm cycles (cut from 4, then 2, for the clock)


def traced_cycles_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``traced_cycles_50k_5k``: warm_cycles_50k_5k's three cycles of the
    twin pipeline (cold; nothing changed; 1% of nodes replaced and a new
    gang) with ``trace: "on"`` in the conf, then the same three cycles over
    a twin world with tracing off; binds, evicts and task states equal
    cycle for cycle. Records ``check_tree`` (empty), each cycle's span tree
    (one ``cycle`` root; snapshot, encode, solve, gang.assign and commit
    under it), each span's duration beside its ``last_timings`` entry,
    ``run_once`` traced and untraced, the Chrome trace (written under
    chiprun_out/), and the exposition read after the traced cycles:
    ``schedule_attempts`` up by 3, ``breaker_state{tier="fused"}`` 0, no
    degraded cycle, five action latencies per cycle. Then the cost of
    tracing on the warm cycle: one scheduler over the untraced arm's world,
    nothing changed since its last cycle, runs WARM_ROUNDS rounds of
    traced, untraced, untraced, traced cycles (``KBT_TRACE`` flipped
    between them, the conf's ``trace:`` empty), after one warm-up cycle of
    each, once with the cyclic collector on and once with it held off
    during each cycle; the medians, spreads and each arm's median
    ``last_timings``."""
    import collections

    import torch

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch import metrics, models, obs
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import encode_cache
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.testing import FakeCache

    on_card = device == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    extra = {} if on_card else {"device": "cpu"}
    pods, nodes = CYCLES_WORLD[0] // cut, CYCLES_WORLD[1] // cut
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    arms = {}
    launches = [0, 0]
    before_text = metrics.render_prometheus_text()
    after_text = ""
    for arm, trace in (("traced", "on"), ("untraced", "off")):
        conf = conf_file(base=PIPELINE_CONF, trace=trace, **extra)
        cache = FakeCache(models.preempt_mix(pods, nodes))
        sched = sched_mod.Scheduler(cache, conf)
        encode_cache.get().invalidate_all("chip_smoke")
        obs.recorder.clear()
        close = sched_mod.close_session
        out = []
        for cycle in range(3):
            if cycle == 2:
                for node_name in sorted(cache.cluster.nodes)[: max(int(nodes * CHURN), 1)]:
                    relabel(cache.cluster.nodes[node_name], "churn")
                add_gang(cache.cluster, "traced-cycles-new-gang", 8)
            cache.binder.binds.clear()
            del cache.evictor.evicts[:]
            states = {}

            def close_reading_states(ssn, discard=False):
                states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values()
                               for t in j.tasks.values()})
                close(ssn, discard=discard)

            sync()
            sched_mod.close_session = close_reading_states
            fs.fused_solve.launches = bs.block_step.launches = 0
            try:
                with GcClock() as gc_clock:
                    t0 = time.perf_counter()
                    sched.run_once()
                    sync()
                    wall_s = time.perf_counter() - t0
            finally:
                sched_mod.close_session = close
            if "aborted" in sched.last_timings:
                raise AssertionError(f"{arm} cycle {cycle + 1} aborted: {sched.last_timings['aborted']}")
            alloc = next(a for a in sched.actions if a.name == "torch_allocate")
            launches[0] += fs.fused_solve.launches
            launches[1] += bs.block_step.launches
            if on_card and (fs.fused_solve.launches, bs.block_step.launches) != (1, 0):
                raise AssertionError(f"{arm} cycle {cycle + 1}: {fs.fused_solve.launches} B1 and "
                                     f"{bs.block_step.launches} B2 launches; expected 1 and 0")
            out.append({"run_once_s": wall_s, "gc_s": gc_clock.record()["gc_s"], "timings": dict(sched.last_timings),
                        "torch_allocate": dict(alloc.last_timings), "tier": alloc.last_solver_tier,
                        "binds": dict(cache.binder.binds), "evicts": list(cache.evictor.evicts),
                        "states": states})
        if arm == "traced":
            after_text = metrics.render_prometheus_text()
            spans = obs.recorder.spans()
        arms[arm] = out
    warm_sched = sched_mod.Scheduler(cache, conf_file(base=PIPELINE_CONF, trace="", **extra))
    warm = {mode: warm_trace_cost(warm_sched, cache, sync, launches, on_card, collector=mode == "collector_on")
            for mode in ("collector_on", "collector_off")}
    # the instrumentation's own cost: one span opened and closed, with an
    # attribute, into the flight recorder's ring
    obs.configure("on")
    obs.recorder.clear()
    t0 = time.perf_counter()
    for _ in range(SPAN_COST_SPANS):
        with obs.span("commit", jobs=1):
            pass
    span_cost_s = (time.perf_counter() - t0) / SPAN_COST_SPANS
    obs.configure()
    obs.recorder.clear()
    for cycle, (t, u) in enumerate(zip(arms["traced"], arms["untraced"])):
        if (t["binds"], t["evicts"], t["states"]) != (u["binds"], u["evicts"], u["states"]):
            raise AssertionError(f"cycle {cycle + 1}: binds, evicts or task states differ with tracing on and off")

    violations = obs.check_tree(spans)
    if violations:
        raise AssertionError(f"the span tree is broken: {violations[:5]}")
    by_trace = collections.defaultdict(list)
    for s in spans:
        by_trace[s["trace_id"]].append(s)
    traces = sorted(by_trace.values(), key=lambda ss: min(s["start_us"] for s in ss))
    if len(traces) != 3:
        raise AssertionError(f"{len(traces)} traces for three cycles")
    per_cycle = []
    for cycle, (trace, t) in enumerate(zip(traces, arms["traced"])):
        by_id = {s["span_id"]: s for s in trace}
        pairs = collections.Counter((s["name"], by_id[s["parent_id"]]["name"] if s["parent_id"] else None)
                                    for s in trace)
        want = collections.Counter({("cycle", None): 1, **{(n, "cycle"): 1 for n in TRACED_SPANS[1:]}})
        if pairs != want:
            raise AssertionError(f"cycle {cycle + 1}: span tree {dict(pairs)}, expected {dict(want)}")
        dur = {s["name"]: s["dur_us"] / 1e6 for s in trace}
        attrs = {s["name"]: s["attrs"] for s in trace}
        if attrs["solve"].get("tier") != "fused" or "warm_fraction" not in attrs["encode"]:
            raise AssertionError(f"cycle {cycle + 1}: span attributes {attrs}")
        a, c = t["torch_allocate"], t["timings"]
        per_cycle.append({
            "span_s": dur,
            "last_timings_s": {"cycle": c["run_once_s"], "snapshot": c["snapshot_s"], "encode": a["encode_s"],
                               "solve": a["solve_s"], "gang.assign": a["replay_s"],
                               "commit": c["close_s"]},
            "warm_fraction": attrs["encode"]["warm_fraction"], "tier": attrs["solve"]["tier"],
        })
    chrome = os.path.join(root, "chiprun_out", "traced_cycles_50k_5k.trace.json")
    os.makedirs(os.path.dirname(chrome), exist_ok=True)
    obs.export_chrome(spans, chrome)

    before, after = exposition_values(before_text), exposition_values(after_text)

    def grew(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    prefix = "kube_batch_tpu_"
    actions = [a.name for a in sched.actions]
    exposition = {
        "schedule_attempts": grew(f"{prefix}schedule_attempts_total"),
        "breaker_state_fused": after.get(f'{prefix}breaker_state{{tier="fused"}}'),
        "degraded_cycles": sum(v for k, v in after.items() if k.startswith(f"{prefix}degraded_cycles_total"))
        - sum(v for k, v in before.items() if k.startswith(f"{prefix}degraded_cycles_total")),
        "action_latency_counts": {
            name: grew(f'{prefix}action_scheduling_latency_count{{action="{name}"}}') for name in actions},
        "series": len([line for line in after_text.splitlines() if line.startswith("# TYPE")]),
    }
    if (exposition["schedule_attempts"], exposition["breaker_state_fused"], exposition["degraded_cycles"]) != (
            3.0, 0.0, 0.0) or len(actions) != 5 or set(exposition["action_latency_counts"].values()) != {3.0}:
        raise AssertionError(f"the exposition after three traced cycles: {exposition}")
    rec = {
        "phase": "traced_cycles_50k_5k", "pods": pods, "nodes": nodes,
        "run_once_s": {arm: [c["run_once_s"] for c in out] for arm, out in arms.items()},
        "gc_s": {arm: [c["gc_s"] for c in out] for arm, out in arms.items()},
        "traced_minus_untraced_s": [t["run_once_s"] - u["run_once_s"]
                                    for t, u in zip(arms["traced"], arms["untraced"])],
        # the same difference with each cycle's cyclic-collector time taken out
        "traced_minus_untraced_net_of_gc_s": [(t["run_once_s"] - t["gc_s"]) - (u["run_once_s"] - u["gc_s"])
                                              for t, u in zip(arms["traced"], arms["untraced"])],
        "spans": len(spans), "span_cost_us": span_cost_s * 1e6,
        "spans_cost_per_cycle_us": span_cost_s * 1e6 * len(spans) / 3,
        "check_tree": violations, "cycles": per_cycle,
        "chrome_trace": os.path.relpath(chrome, root), "exposition": exposition,
        "equal_on_and_off": True, "b1_launches": launches[0], "b2_launches": launches[1],
        "binds_by_cycle": [len(c["binds"]) for c in arms["traced"]],
        "warm_alternating": warm,
    }
    if cut > 1:
        rec["reduced"] = {"pods": [CYCLES_WORLD[0], pods], "nodes": [CYCLES_WORLD[1], nodes]}
    return rec, tuple(launches)


def warm_trace_cost(sched, cache, sync, launches: list, on_card: bool, collector: bool = True) -> dict:
    """Warm cycles of ``sched`` with tracing on and off in the order of
    traced_cycles_phase's docstring; binds, evicts and launches must not
    change from run to run. With ``collector`` False, each cycle runs with
    the cyclic collector off after a full collection outside the timed
    cycle: a generation-2 collection (1-2.6 s at 50k x 5k) cannot land in
    one arm's cycle. Returns each arm's run_once times (and net of the
    collector), their medians and spreads, and each arm's median
    ``last_timings`` entries."""
    import gc

    from kube_batch_tpu_torch import obs
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs

    order = ["traced", "untraced"] + ["traced", "untraced", "untraced", "traced"] * WARM_ROUNDS
    runs = {"traced": [], "untraced": []}
    saved = os.environ.get("KBT_TRACE")
    first = None
    try:
        for i, arm in enumerate(order):
            os.environ["KBT_TRACE"] = "1" if arm == "traced" else "0"
            cache.binder.binds.clear()
            del cache.evictor.evicts[:]
            obs.recorder.clear()
            if not collector:
                gc.collect()
                gc.disable()
            sync()
            fs.fused_solve.launches = bs.block_step.launches = 0
            try:
                with GcClock() as gc_clock:
                    t0 = time.perf_counter()
                    sched.run_once()
                    sync()
                    wall_s = time.perf_counter() - t0
            finally:
                gc.enable()
            launches[0] += fs.fused_solve.launches
            launches[1] += bs.block_step.launches
            if "aborted" in sched.last_timings:
                raise AssertionError(f"warm {arm} run {i}: aborted: {sched.last_timings['aborted']}")
            if on_card and (fs.fused_solve.launches, bs.block_step.launches) != (1, 0):
                raise AssertionError(f"warm {arm} run {i}: {fs.fused_solve.launches} B1 and "
                                     f"{bs.block_step.launches} B2 launches; expected 1 and 0")
            if bool(obs.recorder.spans()) != (arm == "traced"):
                raise AssertionError(f"warm {arm} run {i}: {len(obs.recorder.spans())} spans recorded")
            got = (dict(cache.binder.binds), list(cache.evictor.evicts))
            first = first or got
            if got != first:
                raise AssertionError(f"warm {arm} run {i}: binds or evicts differ from the first warm run's")
            alloc = next(a for a in sched.actions if a.name == "torch_allocate")
            if i >= 2:  # after one warm-up cycle of each arm
                runs[arm].append({"run_once_s": wall_s, "gc_s": gc_clock.record()["gc_s"],
                                  "timings": {**sched.last_timings, **{f"torch_allocate.{k}": v for k, v in
                                                                       alloc.last_timings.items()}}})
    finally:
        if saved is None:
            os.environ.pop("KBT_TRACE", None)
        else:
            os.environ["KBT_TRACE"] = saved
        obs.configure()
        obs.recorder.clear()

    def summary(values):
        return {"median": statistics.median(values), "min": min(values), "max": max(values)}

    out = {"order": order, "warm_up_runs": 2, "runs_per_arm": len(runs["traced"])}
    for arm, rs in runs.items():
        keys = [k for k, v in rs[0]["timings"].items() if isinstance(v, float)]
        out[arm] = {
            "run_once_s": [r["run_once_s"] for r in rs],
            "gc_s": [r["gc_s"] for r in rs],
            "run_once": summary([r["run_once_s"] for r in rs]),
            "run_once_net_of_gc": summary([r["run_once_s"] - r["gc_s"] for r in rs]),
            "median_timings_s": {k: statistics.median(r["timings"][k] for r in rs) for k in keys},
        }
    out["median_traced_minus_untraced_s"] = (out["traced"]["run_once"]["median"]
                                             - out["untraced"]["run_once"]["median"])
    out["median_traced_minus_untraced_net_of_gc_s"] = (out["traced"]["run_once_net_of_gc"]["median"]
                                                       - out["untraced"]["run_once_net_of_gc"]["median"])
    return out


def ladder_trace_phases(clusters: dict, results: dict, device: str = "cuda", cut: int = 1) -> tuple[list[str], dict]:
    """The solver ladder's and the trace's phases: ``ladder_drills``,
    ``overrun_50k_5k`` (drills: they inject their faults) and
    ``traced_cycles_50k_5k`` (undisturbed). Returns the failures and the
    launches of each phase's main path."""
    failures, launches = [], {}

    def drills():
        rec, launches["ladder_drills"] = ladder_drills(device)
        emit(rec)

    def overrun():
        rec, launches["overrun_50k_5k"] = overrun_phase(clusters, results, device, cut)
        emit(rec)

    def traced():
        rec, launches["traced_cycles_50k_5k"] = traced_cycles_phase(device, cut)
        emit(rec)

    run_phase(failures, "ladder_drills", drills, drill=True)
    run_phase(failures, "overrun_50k_5k", overrun, drill=True)
    run_phase(failures, "traced_cycles_50k_5k", traced)
    return failures, launches


# -- the port as a process: store, cache, loop, HTTP --------------------------

SERVER_WORLD = (50_000, 5_000)  # server_50k_5k: preempt_mix(50_000, 5_000), seed 0
SERVER_WAIT_S = 180.0  # the limit on the store showing every bind of the cycle
PROBE = {"min_member": 8, "cpu": 1, "memory": "2Gi"}  # the probe gang posted over HTTP
DRILL_CYCLES = 3  # server_drills' cycles per run: the undisturbed run's fixed point


class StoreBinds:
    """Store-side bind events (a pod's ``node_name`` set where it was
    empty), each stamped on the monotonic clock as the store delivers it:
    ``key -> (node, time)`` of the latest, and ``counts``, each pod's
    number of such events (a pod bound twice counts 2)."""

    def __init__(self, store) -> None:
        import collections

        from kube_batch_tpu_torch.cache.store import PODS, EventHandler

        self.at: dict[str, tuple[str, float]] = {}
        self.counts: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        store.add_event_handler(PODS, EventHandler(on_update=self._update))

    def _update(self, old, new) -> None:
        if new.node_name and not old.node_name:
            key = f"{new.namespace}/{new.name}"
            with self._lock:
                self.at[key] = (new.node_name, time.perf_counter())
                self.counts[key] += 1

    def binds(self) -> dict[str, str]:
        with self._lock:
            return {k: node for k, (node, _) in self.at.items()}

    def last(self, keys=None) -> float:
        with self._lock:
            return max(t for k, (_, t) in self.at.items() if keys is None or k in keys)


class CycleLog:
    """Wraps a ``Scheduler``'s ``run_once`` on its loop thread: per cycle
    its wall clock and split, the pending tasks of its snapshot's valid jobs,
    torch_allocate's split and rung, the B1 and B2 launches and the
    collector's time; and every exception the loop logs (the loop goes on
    after a failed cycle, so the phase reads them here)."""

    def __init__(self, sched, device: str) -> None:
        import torch

        self.cycles: list[dict] = []
        self.errors: list[str] = []
        self._sched = sched
        self._inner = sched.run_once
        self._sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        self._pending = 0
        sched.run_once = self.run_once
        snapshot = sched.cache.snapshot

        def counting_snapshot():
            from kube_batch_tpu_torch.api.types import TaskStatus
            from kube_batch_tpu_torch.framework.session import gate_exempt
            from kube_batch_tpu_torch.plugins.gang import job_valid

            snap = snapshot()
            # only the jobs the session's JobValid gate keeps: a gang whose
            # pods are still being posted (fewer than min_member) is dropped
            # there, and its pending pods leave the allocator nothing to solve
            self._pending = sum(len(j.task_status_index.get(TaskStatus.PENDING, ())) for j in snap.jobs.values()
                                if gate_exempt(j) or job_valid(j) is None)
            return snap

        sched.cache.snapshot = counting_snapshot

    def run_once(self) -> None:
        from kube_batch_tpu_torch.ops import block_step as bs
        from kube_batch_tpu_torch.ops import fused_solve as fs

        b1, b2 = fs.fused_solve.launches, bs.block_step.launches
        self._pending = 0
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            try:
                self._inner()
                self._sync()
            except Exception as e:
                self.errors.append(f"{type(e).__name__}: {e}")
                raise
            finally:
                wall_s = time.perf_counter() - t0
        alloc = next(a for a in self._sched.actions if a.name == "torch_allocate")
        self.cycles.append({
            "run_once_s": wall_s, "cycle": dict(self._sched.last_timings), "pending": self._pending,
            "torch_allocate": dict(alloc.last_timings), "last_solver_tier": alloc.last_solver_tier,
            "b1_launches": fs.fused_solve.launches - b1, "b2_launches": bs.block_step.launches - b2,
            **gc_clock.record(),
        })

    def check(self, phase: str) -> None:
        """No cycle failed or aborted, and every cycle with pending tasks
        solved on the fused rung (one with none solves nothing: rung
        ``none``). ``skipped`` cycles are the staleness drill's to check."""
        if self.errors:
            raise AssertionError(f"{phase}: failed cycles: {self.errors}")
        for i, c in enumerate(self.cycles):
            if "aborted" in c["cycle"]:
                raise AssertionError(f"{phase}: cycle {i} aborted: {c['cycle']['aborted']}")
            want = "fused" if c["pending"] else "none"
            if "skipped" not in c["cycle"] and c["last_solver_tier"] != want:
                raise AssertionError(f"{phase}: cycle {i} with {c['pending']} pending tasks ran on the "
                                     f"{c['last_solver_tier']!r} rung ({c['torch_allocate'].get('serial_reason')})")


def store_checks(store) -> dict:
    """Gang and capacity invariants over the store: no PodGroup with between
    1 and min_member - 1 pods bound, and no node whose bound, non-terminal
    pods request more than its allocatable."""
    import collections

    from kube_batch_tpu_torch.api.helpers import get_pod_resource_request
    from kube_batch_tpu_torch.api.resource_info import Resource
    from kube_batch_tpu_torch.apis.types import GROUP_NAME_ANNOTATION_KEY, PodPhase

    bound = collections.Counter()
    used: dict[str, Resource] = {}
    for pod in store.list("pods"):
        if not pod.node_name or pod.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
            continue
        group = pod.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY)
        if group:
            bound[f"{pod.namespace}/{group}"] += 1
        used.setdefault(pod.node_name, Resource.empty()).add(get_pod_resource_request(pod))
    partial = [key for pg in store.list("podgroups")
               if 0 < bound[(key := f"{pg.metadata.namespace}/{pg.name}")] < pg.spec.min_member]
    over = [node.name for node in store.list("nodes")
            if node.name in used and not used[node.name].less_equal(Resource.from_resource_list(node.allocatable))]
    if partial or over:
        raise AssertionError(f"{len(partial)} partly bound gangs ({partial[:3]}), "
                             f"{len(over)} nodes over capacity ({over[:3]})")
    return {"gangs_bound": sum(1 for v in bound.values() if v), "nodes_used": len(used),
            "partial_gangs": 0, "nodes_over_capacity": 0}


def http(base: str, method: str, path: str, body=None) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def server_phase(device: str = "cuda", cut: int = 1, shared: dict | None = None) -> tuple[dict, tuple[int, int]]:
    """``server_50k_5k``: the port as a process over ``preempt_mix(50_000,
    5_000)`` (seed 0, config 4). The world is generated twice from the
    seed: once into a ``ClusterStore`` through its API (PodGroups
    Pending), once as the ``FakeCache`` world of the same conf's cycle,
    whose binds the store must come to show. Then ``SchedulerServer(store=
    ..., schedule_period=1.0)`` with the twin pipeline conf runs its loop
    on ``cuda:0``; after every bind has landed, a probe gang (8 pods of 1
    cpu / 2Gi, ``min_member`` 8) is posted over HTTP and must bind in
    full; the HTTP reads and ``stop()`` (which must join the server's
    threads) end it."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.cache import ClusterStore
    from kube_batch_tpu_torch.server import SchedulerServer

    on_card = device == "cuda"
    pods, nodes = SERVER_WORLD[0] // cut, SERVER_WORLD[1] // cut
    conf = conf_file(base=PIPELINE_CONF, **({} if on_card else {"device": "cpu"}))

    # the FakeCache twin: the same world and conf, one cycle on the card
    twin, twin_cache, _ = pipeline_cycle("server_twin", models.preempt_mix(pods, nodes), conf, device)
    want = dict(twin_cache.binder.binds)
    del twin_cache
    if shared is not None:
        shared["want"] = want  # ha_failover_50k_5k's reference too
    t0 = time.perf_counter()
    world = models.preempt_mix_objects(pods, nodes)
    generate_s = time.perf_counter() - t0
    store = ClusterStore()
    t0 = time.perf_counter()
    tt.seed_store(store, *world)
    ingest_s = time.perf_counter() - t0
    binds = StoreBinds(store)
    t0 = time.perf_counter()
    srv = SchedulerServer(listen_address="127.0.0.1:0", schedule_period=1.0, scheduler_conf=conf, store=store,
                          device="cuda:0" if on_card else None)
    cache_sync_s = time.perf_counter() - t0
    log = CycleLog(srv.scheduler, device)
    dispatched: list[float] = []
    bind_many = srv.cache.bind_many

    def timed_bind_many(pairs, keys=None):
        dispatched.append(time.perf_counter())
        return bind_many(pairs, keys=keys)

    srv.cache.bind_many = timed_bind_many
    threads_before = set(threading.enumerate())
    t_start = time.perf_counter()
    srv.start()
    base = f"http://127.0.0.1:{srv.listen_port}"
    try:
        deadline = time.monotonic() + SERVER_WAIT_S
        while time.monotonic() < deadline and len(binds.at) < len(want) and not log.errors:
            time.sleep(0.05)
        all_bound_s = time.perf_counter() - t_start
        log.check("server_50k_5k")
        got = binds.binds()
        if got != want:
            missing = len(set(want) - set(got))
            moved = sum(1 for k in want if k in got and got[k] != want[k])
            raise AssertionError(f"the store's binds differ from the FakeCache cycle's: {len(got)} against "
                                 f"{len(want)}, {missing} missing, {moved} on another node")
        write_back_s = binds.last(want) - dispatched[0]
        checks = store_checks(store)

        # the probe gang, over HTTP
        probe_keys = [f"default/probe-{i}" for i in range(PROBE["min_member"])]
        codes = [http(base, "POST", "/apis/v1alpha1/podgroups", {"name": "probe", "min_member": PROBE["min_member"]})[0]]
        for key in probe_keys:
            codes.append(http(base, "POST", "/apis/v1alpha1/pods", {
                "name": key.split("/")[1], "group": "probe",
                "requests": {"cpu": PROBE["cpu"], "memory": PROBE["memory"]}})[0])
        posted = time.perf_counter()
        if codes != [201] * len(codes):
            raise AssertionError(f"the probe's POSTs answered {codes}")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(k in binds.at for k in probe_keys) and not log.errors:
            time.sleep(0.01)
        log.check("server_50k_5k")
        if not all(k in binds.at for k in probe_keys):
            raise AssertionError("the probe gang did not bind in full")
        probe_bind_s = binds.last(probe_keys) - posted
        probe_nodes = sorted({binds.at[k][0] for k in probe_keys})
        checks = store_checks(store)

        reads = {}
        for path in ("/healthz", "/version", "/metrics", "/apis/v1alpha1/podgroups"):
            reads[path] = http(base, "GET", path)
        status = {p: code for p, (code, _) in reads.items()}
        if set(status.values()) != {200}:
            raise AssertionError(f"HTTP reads answered {status}")
        attempts = exposition_values(reads["/metrics"][1]).get("kube_batch_tpu_schedule_attempts_total")
        podgroups = len(json.loads(reads["/apis/v1alpha1/podgroups"][1])["items"])
    finally:
        t0 = time.perf_counter()
        srv.stop()
        stop_s = time.perf_counter() - t0
    alive = [t for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if alive:
        t0 = time.perf_counter()
        for t in alive:
            t.join(timeout=120)
        raise AssertionError(f"stop() left threads running after {stop_s:.3f} s: {[t.name for t in alive]}, "
                             f"joined {time.perf_counter() - t0:.3f} s later; cycles: "
                             f"{[(c['run_once_s'], c['last_solver_tier'], c['pending']) for c in log.cycles]}")
    cycles = log.cycles
    rec = {
        "phase": "server_50k_5k", "pods": pods, "nodes": nodes, "generate_s": generate_s,
        "ingest_s": ingest_s, "cache_sync_s": cache_sync_s, "store_objects": sum(len(w) for w in world),
        "all_bound_s": all_bound_s, "write_back_s": write_back_s, "dispatches": len(dispatched),
        "binds": len(want), "equal_to_fakecache_cycle": True, "twin_run_once_s": twin["run_once_s"],
        "probe_bind_s": probe_bind_s, "probe_nodes": probe_nodes, "http_status": status,
        "schedule_attempts": attempts, "podgroups_listed": podgroups, "stop_s": stop_s, **checks,
        "cycles": [{
            "run_once_s": c["run_once_s"], "snapshot_s": c["cycle"].get("snapshot_s"),
            "actions_s": {k: v for k, v in c["cycle"].items() if k.endswith("_s") and k not in (
                "conf_s", "snapshot_s", "plugins_s", "job_valid_s", "close_s", "run_once_s")},
            "encode_s": c["torch_allocate"].get("encode_s"), "warm_fraction": c["torch_allocate"].get("warm_fraction"),
            "b1_s": c["torch_allocate"].get("kernel_s", c["torch_allocate"].get("solve_s")),
            "b1_launches": c["b1_launches"], "replay_s": c["torch_allocate"].get("replay_s"),
            "gc_s": c["gc_s"], "last_solver_tier": c["last_solver_tier"],
        } for c in cycles],
        "b1_launches": sum(c["b1_launches"] for c in cycles), "b2_launches": sum(c["b2_launches"] for c in cycles),
    }
    if on_card and (rec["b1_launches"] < 2 or rec["b2_launches"]):
        raise AssertionError(f"{rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches; expected at least two "
                             "B1 launches (the world's cycle and the probe's) and no B2")
    if cut > 1:
        rec["reduced"] = {"pods": [SERVER_WORLD[0], pods], "nodes": [SERVER_WORLD[1], nodes]}
    return rec, (rec["b1_launches"], rec["b2_launches"])


def settle(cache, timeout: float = 60.0) -> None:
    """Wait until the cache's write pool has landed every bind it was given
    and the resync queue is empty: no task of the mirror is Binding."""
    from kube_batch_tpu_torch.api.types import TaskStatus

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with cache._mutex:
            binding = any(t.status == TaskStatus.BINDING for j in cache.jobs.values() for t in j.tasks.values())
        if not binding and len(cache._err_tasks) == 0:
            return
        time.sleep(0.01)
    raise AssertionError("the cache's writes did not settle")


def server_drills(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``server_drills``: the cache's write side and the loop's guards under
    injected faults, each drill over a fresh store seeded with
    ``preempt_mix(2000, 40, seed=1)`` and a fresh ``SchedulerCache`` (its
    pools running), the twin conf with ``min_device_pairs: 0``, one
    ``run_once`` per cycle, against an undisturbed run on the same world:
    (a) ``bind.write`` fires once: the write is retried in place and
    ``write_retries_total{op="bind"}`` counts 1; (b) ``bind.write`` with
    ``KBT_WRITE_RETRIES=0``: the task goes through the errTasks resync
    and binds on a later cycle; (c) a cache whose ``snapshot_age``
    exceeds ``KBT_MAX_SNAPSHOT_AGE_S``: the cycle is skipped,
    ``stale_cycles_skipped_total`` counts 1 and nothing binds; (d)
    ``KBT_CACHE_MUTATION_DETECTOR=1`` over a full cycle: no violation.
    Every drill ends with the undisturbed run's binds."""
    from kube_batch_tpu_torch import faults, metrics, models
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
    from kube_batch_tpu_torch.scheduler import Scheduler

    on_card = device == "cuda"
    conf = conf_file(base=PIPELINE_CONF, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
    cpu_conf = conf_file(base=PIPELINE_CONF, min_device_pairs=0, device="cpu")
    env_keys = ("KBT_WRITE_RETRIES", "KBT_MAX_SNAPSHOT_AGE_S", "KBT_CACHE_MUTATION_DETECTOR")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    launches = [0, 0]

    def run(cycles: int, env: dict, age: float = 0.0, arm=None, after_first=None, device: str = device) -> dict:
        for k in env_keys:
            os.environ.pop(k, None)
        os.environ.update(env)
        ages = [age]
        store = ClusterStore()
        tt.seed_store(store, *models.preempt_mix_objects(*DRILL_WORLD[:2], seed=DRILL_WORLD[2]))
        binds = StoreBinds(store)
        cache = SchedulerCache(store, staleness_fn=lambda: ages[0])
        sched = Scheduler(cache, conf if device == "cuda" or not on_card else cpu_conf)
        log = CycleLog(sched, device)
        cache.run()
        faults.registry.reset()
        try:
            per_cycle, first = [], {}
            for i in range(cycles):
                if i == 0 and arm is not None:
                    faults.registry.arm(arm, count=1)
                sched.run_once()
                settle(cache)  # the pool's writes, where the fault point fires
                faults.registry.reset()
                per_cycle.append(len(binds.at))
                if i == 0:
                    first = binds.binds()
                if i == 0 and after_first is not None:
                    after_first(ages)
                    settle(cache)
        finally:
            faults.registry.reset()
            cache.stop()
            for k, v in saved_env.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        log.check("server_drills")
        store_checks(store)
        if device == "cuda":
            launches[0] += sum(c["b1_launches"] for c in log.cycles)
            launches[1] += sum(c["b2_launches"] for c in log.cycles)
        return {"binds": binds.binds(), "first": first, "per_cycle": per_cycle, "cycles": log.cycles}

    def delta(metric, labels=None):
        before = metric.value(labels)
        return lambda: metric.value(labels) - before

    t0 = time.perf_counter()
    # the store's victims are deleted by the first cycle's evictions, and
    # the second cycle binds into the capacity they free: the third finds
    # the fixed point every drill must end at
    base = run(DRILL_CYCLES, {})
    want = base["binds"]
    if not want or base["per_cycle"][-2] != len(want):
        raise AssertionError(f"the undisturbed run bound {base['per_cycle']}: no fixed point")
    out = {"phase": "server_drills", "world": "preempt_mix(%d, %d, seed=%d)" % DRILL_WORLD,
           "undisturbed": {"binds": len(want), "run_once_s": [c["run_once_s"] for c in base["cycles"]]}}

    retries = delta(metrics.write_retries, {"op": "bind"})
    a = run(DRILL_CYCLES, {}, arm="bind.write")
    if (retries(), a["binds"], a["per_cycle"]) != (1.0, want, base["per_cycle"]):
        raise AssertionError(f"(a) bind.write once: {retries()} retries, binds equal: {a['binds'] == want}")
    out["a_bind_write_retried"] = {"write_retries": retries(), "binds": len(a["binds"])}

    retries = delta(metrics.write_retries, {"op": "bind"})
    b = run(DRILL_CYCLES, {"KBT_WRITE_RETRIES": "0"}, arm="bind.write")
    rejected = sorted(set(base["first"]) - set(b["first"]))
    if retries() or b["per_cycle"][0] != base["per_cycle"][0] - 1 or not set(rejected) <= set(b["binds"]):
        raise AssertionError(f"(b) bind.write with no retry: {retries()} retries, binds per cycle "
                             f"{b['per_cycle']} against {base['per_cycle']}, {rejected} bound later: "
                             f"{set(rejected) <= set(b['binds'])}")
    # the rejected pod's capacity stays free in its cycle, so the later
    # cycles place around it: the fixed point is the same drill's on the CPU
    # (the kernel's plain version), not the undisturbed run's
    b_cpu = b if not on_card else run(DRILL_CYCLES, {"KBT_WRITE_RETRIES": "0"}, arm="bind.write", device="cpu")
    if b["binds"] != b_cpu["binds"]:
        raise AssertionError("(b) the drill's binds on the card differ from the same drill's on the CPU")
    out["b_bind_write_resynced"] = {"rejected": rejected, "binds_per_cycle": b["per_cycle"],
                                    "binds_moved_from_undisturbed": sum(1 for k in want if b["binds"].get(k) != want[k]),
                                    "equal_to_cpu_drill": True}

    skipped = delta(metrics.stale_cycles_skipped)
    c = run(DRILL_CYCLES + 1, {"KBT_MAX_SNAPSHOT_AGE_S": "5"}, age=60.0,
            after_first=lambda ages: ages.__setitem__(0, 0.0))
    if skipped() != 1.0 or c["per_cycle"][0] != 0 or c["binds"] != want:
        raise AssertionError(f"(c) stale snapshot: {skipped()} skipped, binds per cycle {c['per_cycle']}")
    if c["cycles"][0]["cycle"].get("skipped") != "stale_snapshot":
        raise AssertionError(f"(c) the first cycle was not skipped: {c['cycles'][0]['cycle']}")
    out["c_stale_snapshot_skipped"] = {"stale_cycles_skipped": skipped(), "binds_per_cycle": c["per_cycle"]}

    violations = delta(metrics.cache_mutation_violations, {"kind": "pods"})
    d = run(DRILL_CYCLES, {"KBT_CACHE_MUTATION_DETECTOR": "1"})
    if violations() or d["binds"] != want:
        raise AssertionError(f"(d) mutation detector: {violations()} violations, binds equal: {d['binds'] == want}")
    out["d_mutation_detector_clean"] = {"violations": violations(), "run_once_s": d["cycles"][0]["run_once_s"],
                                       "undisturbed_run_once_s": base["cycles"][0]["run_once_s"]}
    if on_card and (launches[0] < 4 * DRILL_CYCLES or launches[1]):
        raise AssertionError(f"{launches[0]} B1 and {launches[1]} B2 launches over the drills")
    out.update(s=time.perf_counter() - t0, b1_launches=launches[0], b2_launches=launches[1])
    return out, tuple(launches)


# -- the port as an HA pair: leader election, the journal, takeover ----------

# ha_failover_50k_5k's lease: the example's ratios (duration, 0.7 of it to
# renew, 0.1 of it between tries), long enough that a generation-2
# collection of up to 2.7 s (PERF.md) cannot stall a renewal past its
# deadline; the reference's defaults are 15 s / 10 s / 5 s
HA_LEASE = {"lease_duration": 6.0, "renew_deadline": 4.2, "retry_period": 0.6}
HA_DRILL_LEASE = {"lease_duration": 2.0, "renew_deadline": 1.4, "retry_period": 0.2}  # ha_drills' lease
HA_KILL_AFTER = 20_000  # store binds the leader's write pool lands before it dies (of 50,000)
# the leader's first binds land beside its loop's idle cycles (period 1 s),
# the rest with the loop waiting: each confirm's flushed write releases the
# interpreter lock, and a thread busy in Python holds it up to the switch
# interval (5 ms) before the write pool's thread gets it back
HA_BESIDE_BINDS = 1_000
# the same in ha_drills' leader (of its first cycle's 1,502), for (d) and (e);
# (f) dies after 100, while some node a straddling gang's orphans target
# holds no pod yet (see delete_a_target_node)
HA_DRILL_KILL_AFTER = {"d_journal_replay": 700, "e_reconcile_scan": 700, "f_half_bound_gang_rollback": 100}
HA_DRILL_B_PERIOD = 0.3  # the standby's loop period in ha_drills


class LeaderKilled(BaseException):
    """SIGKILL in the leader's kb-write pool: a ``BaseException``, so
    neither the write retry nor the resync routing (both catch
    ``Exception``) survives it, and the rest of the pool's batch never runs
    (``concurrent.futures`` keeps it on the batch's future)."""


class DyingBinder:
    """The leader's binder: the store binder until ``left`` binds have
    landed, then ``LeaderKilled`` on every call (``killed_at`` stamps the
    first)."""

    def __init__(self, store, left: int) -> None:
        from kube_batch_tpu_torch.cache.cache import StoreBinder

        self._inner = StoreBinder(store)
        self.left = left
        self.killed = threading.Event()
        self.killed_at = 0.0

    def bind(self, pod, hostname: str) -> None:
        if self.left <= 0:
            if not self.killed.is_set():
                self.killed_at = time.perf_counter()
                self.killed.set()
            raise LeaderKilled()
        self.left -= 1
        self._inner.bind(pod, hostname)


class JournalClock:
    """Wall time of one journal's appends, confirms and compactions (its
    instance methods wrapped; a confirm's time includes any compaction it
    runs)."""

    def __init__(self, journal) -> None:
        self.append_s: list[float] = []
        self.confirm_s = 0.0
        self.confirms = 0
        self.compact_s: list[float] = []
        for name in ("append_intents", "confirm", "compact"):
            inner = getattr(journal, name)
            setattr(journal, name, self._timed(name, inner))

    def _timed(self, name: str, inner):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                if name == "append_intents":
                    self.append_s.append(dt)
                elif name == "confirm":
                    self.confirm_s += dt
                    self.confirms += 1
                else:
                    self.compact_s.append(dt)

        return timed

    def record(self) -> dict:
        return {"append_s": self.append_s, "confirms": self.confirms, "confirm_s": self.confirm_s,
                "compactions": len(self.compact_s), "compact_s": self.compact_s}


def placements(store) -> dict[str, str]:
    return {f"{p.namespace}/{p.name}": p.node_name for p in store.list("pods")}


def join_new_threads(before: set, what: str, timeout: float = 30.0) -> None:
    """Every thread started since ``before`` has ended (the servers' and the
    electors' threads, the standby's acquire)."""
    deadline = time.monotonic() + timeout
    for t in set(threading.enumerate()) - before:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
    if alive:
        raise AssertionError(f"{what}: threads still running: {alive}")


class HaPair:
    """Leader A and standby B over one store and one journal file, each a
    ``SchedulerServer`` under an elector: a ``StoreLeaseElector`` over the
    arbiter's URL, or a ``LeaderElector`` over a lock file. B's elector
    blocks in ``acquire(blocking=True)`` on a thread of its own from the
    start; B's server is made, reconciles and starts its loop once it
    holds the lease, as ``run()`` does."""

    def __init__(self, store, conf: str, device: str, wal: str, arbiter: str | None, lease_name: str,
                 lease: dict, lock_file: str | None = None) -> None:
        self.store, self.conf, self.device, self.wal = store, conf, device, wal
        self.arbiter, self.lease_name, self.lease, self.lock_file = arbiter, lease_name, lease, lock_file
        self.srv_a = self.srv_b = self.log_a = self.log_b = None
        self.lost_at = 0.0
        self.holder_at_lost = None
        self.lost = threading.Event()
        self.acquired_b = threading.Event()
        self.acquired_b_at = 0.0
        self.reports: list = []
        self._standby_thread = None
        self.reconcile_s = 0.0
        self.violations: list = []
        self.el_a = self._elector("ha-a")
        self.el_b = self._elector("ha-b")

    def _elector(self, identity: str):
        from kube_batch_tpu_torch.server import LeaderElector, StoreLeaseElector

        if self.lock_file is not None:
            return LeaderElector(self.lock_file, identity)
        return StoreLeaseElector(self.arbiter, self.lease_name, identity, **self.lease)

    def server(self, period: float):
        from kube_batch_tpu_torch.server import SchedulerServer

        return SchedulerServer(listen_address="127.0.0.1:0", schedule_period=period, scheduler_conf=self.conf,
                               store=self.store, journal_path=self.wal,
                               device="cuda:0" if self.device == "cuda" else None)

    def start_leader(self, period: float, binder=None, before_start=None) -> None:
        if not self.el_a.acquire(blocking=False):
            raise AssertionError("the leader could not take a free lease")
        self.srv_a = self.server(period)
        if binder is not None:
            self.srv_a.cache.binder = binder
        self.log_a = CycleLog(self.srv_a.scheduler, self.device)
        if before_start is not None:
            before_start(self.srv_a)
        self.srv_a.start()
        if self.lock_file is None:
            self.el_a.start_renewing(self._on_lost)
        self._standby_thread = threading.Thread(target=self._standby, name="ha-standby", daemon=True)
        self._standby_thread.start()

    def _on_lost(self) -> None:
        # what run()'s os._exit(1) would stop: the caller stops A's server
        self.lost_at = time.perf_counter()
        self.holder_at_lost = self.store_lease_holder()
        self.lost.set()

    def store_lease_holder(self):
        import urllib.request

        with urllib.request.urlopen(f"{self.arbiter}/apis/v1alpha1/leases", timeout=10) as r:
            items = json.loads(r.read())["items"]
        return next((i["holder"] for i in items if i["name"] == self.lease_name), None)

    def _standby(self) -> None:
        if self.el_b.acquire(blocking=True):
            self.acquired_b_at = time.perf_counter()
            self.acquired_b.set()

    def kill_leader(self) -> None:
        """A dies: its renewals stop with no release (or, on a lock file,
        the kernel drops the dead process's lock), and its server stops."""
        if self.lock_file is None:
            self.el_a._stop.set()
        else:
            self.el_a.release()
        self.srv_a.stop()

    def start_standby(self, period: float, timeout: float, arm=None) -> None:
        from kube_batch_tpu_torch import faults
        from kube_batch_tpu_torch.faults.mutation_detector import MutationDetector

        if not self.acquired_b.wait(timeout):
            raise AssertionError(f"the standby did not take over within {timeout} s")
        t0 = time.perf_counter()
        self.srv_b = self.server(period)
        self.cache_sync_b_s = time.perf_counter() - t0
        self.log_b = CycleLog(self.srv_b.scheduler, self.device)
        self.journal_b = JournalClock(self.srv_b.journal)
        inner = self.srv_b.reconcile

        def reconcile():  # start() calls it before the loop thread starts
            detector = MutationDetector(self.store)
            detector.snapshot()
            t0 = time.perf_counter()
            report = inner()
            self.reconcile_s = time.perf_counter() - t0
            self.violations = detector.violations()
            self.reports.append(report)
            return report

        self.srv_b.reconcile = reconcile
        if arm is not None:
            faults.registry.arm(arm[0], **arm[1])
        self.srv_b.start()
        if arm is not None:
            faults.registry.reset()

    def wait_b_cycles(self, n: int, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while len(self.log_b.cycles) < n and not self.log_b.errors and time.monotonic() < deadline:
            time.sleep(0.02)
        if len(self.log_b.cycles) < n:
            raise AssertionError(f"the standby ran {len(self.log_b.cycles)} cycles of {n} in {timeout} s "
                                 f"({self.log_b.errors})")

    def stop(self) -> None:
        for srv in (self.srv_a, self.srv_b):
            if srv is not None and srv._threads:
                srv.stop()
        self.el_a.release()  # on a lock file, lets a standby still blocked through
        if self.lock_file is None:
            self.el_b._stop.set()  # ends a standby still contending
        if self._standby_thread is not None:
            self._standby_thread.join(timeout=10)
        self.el_b.release()

    def launches(self) -> tuple[int, int]:
        logs = [log for log in (self.log_a, self.log_b) if log is not None]
        return (sum(c["b1_launches"] for log in logs for c in log.cycles),
                sum(c["b2_launches"] for log in logs for c in log.cycles))


def arbiter_server():
    """The compose file's ``store`` service: a scheduler with no workload
    and an hour's period (on the CPU: it solves nothing), whose HTTP API
    arbitrates the lease."""
    from kube_batch_tpu_torch.server import SchedulerServer

    srv = SchedulerServer(listen_address="127.0.0.1:0", schedule_period=3600.0,
                          scheduler_conf=conf_file(base=PIPELINE_CONF, device="cpu"))
    srv.start()
    return srv, f"http://127.0.0.1:{srv.listen_port}"


def fsck_strict(path: str) -> tuple[int, str]:
    """``python -m kube_batch_tpu_torch.recovery.fsck --strict PATH``, in
    this process: its exit code and output."""
    import contextlib
    import io

    from kube_batch_tpu_torch.recovery import fsck

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fsck.main(["--strict", path])
    return rc, out.getvalue().strip()


def ha_failover_phase(device: str = "cuda", cut: int = 1, want: dict | None = None) -> tuple[dict, tuple[int, int]]:
    """``ha_failover_50k_5k``: leader A (``SchedulerServer`` over a store
    seeded with ``preempt_mix(50_000, 5_000)``, a journal, the twin
    pipeline on ``cuda:0``, period 1 s, holding the lease of an arbiter
    server) solves the world and dies in its write-back after
    ``HA_KILL_AFTER`` store binds; its renewals stop with no release and
    its server stops. Standby B, blocked on the lease, takes over once it
    expires, reconciles the journal against the store in ``start()`` and
    runs its loop. The store must end at ``want`` (the FakeCache twin's
    binds, from ``server_50k_5k``), each pod bound once, no gang partly
    bound, no node past its allocatable, the journal empty of outstanding
    intents and ``fsck --strict`` clean."""
    import gc
    import tempfile

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.cache import ClusterStore

    on_card = device == "cuda"
    pods, nodes = SERVER_WORLD[0] // cut, SERVER_WORLD[1] // cut
    kill_after, beside_binds = HA_KILL_AFTER // cut, HA_BESIDE_BINDS // cut
    conf = conf_file(base=PIPELINE_CONF, **({} if on_card else {"device": "cpu"}))
    if want is None:  # server_50k_5k did not run: solve the twin here
        _, twin_cache, _ = pipeline_cycle("ha_twin", models.preempt_mix(pods, nodes), conf, device)
        want = dict(twin_cache.binder.binds)
        del twin_cache
    threads_before = set(threading.enumerate())
    arbiter, url = arbiter_server()
    tmp = tempfile.mkdtemp(prefix="kbt-ha-")
    wal = os.path.join(tmp, "leader.wal")
    store = ClusterStore()
    t0 = time.perf_counter()
    tt.seed_store(store, *models.preempt_mix_objects(pods, nodes))
    ingest_s = time.perf_counter() - t0
    binds = StoreBinds(store)
    pair = HaPair(store, conf, device, wal, url, "kb-ha", HA_LEASE)
    binder = DyingBinder(store, kill_after)
    dispatched: list[float] = []
    clocks = {}

    def instrument(srv) -> None:
        clocks["a"] = JournalClock(srv.journal)
        bind_many = srv.cache.bind_many

        def timed_bind_many(pairs, keys=None):
            dispatched.append(time.perf_counter())
            return bind_many(pairs, keys=keys)

        srv.cache.bind_many = timed_bind_many

    try:
        pair.start_leader(1.0, binder=binder, before_start=instrument)
        # the write-back beside the loop's idle cycles for the first
        # binds, then alone: the loop ends after its cycle in flight while
        # the cache's pools go on
        deadline = time.monotonic() + SERVER_WAIT_S
        while len(binds.at) < beside_binds and time.monotonic() < deadline and not binder.killed.is_set():
            time.sleep(0.01)
        t_switch = time.perf_counter()
        beside = len(binds.at)
        pair.srv_a._stop.set()
        next(t for t in pair.srv_a._threads if t.name == "kb-loop").join(timeout=60)
        t_alone = time.perf_counter()
        if not binder.killed.wait(SERVER_WAIT_S):
            raise AssertionError(f"the leader did not reach its kill: {len(binds.at)} binds, {pair.log_a.errors}")
        killed_at = binder.killed_at
        landed = dict(binds.binds())
        pair.kill_leader()
        a_stopped_s = time.perf_counter() - killed_at
        pair.log_a.check("ha_failover_50k_5k (leader)")
        if pair.lost.is_set():
            raise AssertionError(f"the leader lost its lease before its kill: holder {pair.holder_at_lost}")
        a_cycles, a_journal = pair.log_a.cycles, clocks["a"].record()
        pair.srv_a = None  # only the store's handlers keep A's cache now
        t0 = time.perf_counter()
        gc.collect()
        gc_before_b_s = time.perf_counter() - t0
        pair.start_standby(1.0, timeout=HA_LEASE["lease_duration"] + 30)
        takeover_s = pair.acquired_b_at - killed_at
        deadline = time.monotonic() + SERVER_WAIT_S
        while time.monotonic() < deadline and len(binds.at) < len(want) and not pair.log_b.errors:
            time.sleep(0.05)
        all_bound_s = time.perf_counter() - pair.acquired_b_at
        pair.wait_b_cycles(1, 120)
        pair.log_b.check("ha_failover_50k_5k (standby)")
        got = placements(store)
        moved = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
        if moved:
            raise AssertionError(f"{len(moved)} of {len(want)} pods not where the FakeCache cycle binds them: "
                                 f"{list(moved.items())[:3]}")
        twice = {k: n for k, n in binds.counts.items() if n != 1}
        if twice or set(binds.counts) != set(want):
            raise AssertionError(f"bound more than once: {list(twice.items())[:3]}; "
                                 f"{len(set(want) - set(binds.counts))} never bound")
        checks = store_checks(store)
        (report,) = pair.reports
        rep = report.as_dict()
        if rep["aborted"] or rep["rolled_back"] or rep["redispatched"] + len(landed) != len(want):
            raise AssertionError(f"reconciliation {rep} after {len(landed)} landed binds, of {len(want)}")
        if pair.violations:
            raise AssertionError(f"the mutation detector around reconciliation: {pair.violations[:3]}")
        outstanding = len(pair.srv_b.journal.outstanding())
        b_cycles, b_journal = pair.log_b.cycles, pair.journal_b.record()
    finally:
        pair.stop()
        arbiter.stop()
    rc, fsck_out = fsck_strict(wal)
    if outstanding or rc != 0:
        raise AssertionError(f"{outstanding} intents outstanding after the standby's write-back; fsck --strict "
                             f"exited {rc}: {fsck_out}")
    join_new_threads(threads_before, "ha_failover_50k_5k")
    alone = sum(1 for k, (_, t) in binds.at.items() if k in landed and t >= t_alone)
    if not beside or not alone:
        raise AssertionError(f"the leader landed {beside} binds beside its loop and {alone} alone")
    rec = {
        "phase": "ha_failover_50k_5k", "pods": pods, "nodes": nodes, "ingest_s": ingest_s,
        "lease": HA_LEASE, "kill_after_binds": kill_after,
        "journal_append_s": a_journal["append_s"][0] if a_journal["append_s"] else None,
        "journal_appends": len(a_journal["append_s"]),
        "leader_binds_landed": len(landed),
        "leader_binds_beside_loop": beside,
        "leader_ms_per_bind_beside_loop": 1e3 * (t_switch - dispatched[0]) / beside,
        "leader_binds_alone": alone, "leader_ms_per_bind_alone": 1e3 * (killed_at - t_alone) / alone,
        "leader_confirm_s": a_journal["confirm_s"], "leader_confirms": a_journal["confirms"],
        "leader_compactions": a_journal["compactions"], "leader_compact_s": a_journal["compact_s"],
        "leader_stop_s": a_stopped_s, "gc_before_standby_s": gc_before_b_s,
        "takeover_s": takeover_s, "standby_cache_sync_s": pair.cache_sync_b_s,
        "reconcile_s": pair.reconcile_s, "reconcile_report": rep,
        "standby_confirms": b_journal["confirms"], "standby_compactions": b_journal["compactions"],
        "standby_compact_s": b_journal["compact_s"], "all_bound_s": all_bound_s, "binds": len(want),
        "equal_to_fakecache_cycle": True, "each_pod_bound_once": True, "mutation_violations": 0,
        "outstanding_after": outstanding, "fsck_strict_rc": rc, "fsck": fsck_out, **checks,
        "cycles": [{"server": who, "run_once_s": c["run_once_s"], "pending": c["pending"],
                    "b1_launches": c["b1_launches"], "gc_s": c["gc_s"], "last_solver_tier": c["last_solver_tier"]}
                   for who, cycles in (("leader", a_cycles), ("standby", b_cycles)) for c in cycles],
        "b1_launches": sum(c["b1_launches"] for c in a_cycles + b_cycles),
        "b2_launches": sum(c["b2_launches"] for c in a_cycles + b_cycles),
    }
    if on_card and (rec["b1_launches"] < 1 or rec["b2_launches"]):
        raise AssertionError(f"{rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches; expected the "
                             "leader's cycle to launch B1 and nothing to launch B2")
    if cut > 1:
        rec["reduced"] = {"pods": [SERVER_WORLD[0], pods], "nodes": [SERVER_WORLD[1], nodes],
                          "kill_after_binds": [HA_KILL_AFTER, kill_after]}
    return rec, (rec["b1_launches"], rec["b2_launches"])


def ha_drill(kind: str, device: str, url: str, conf: str, tmp: str) -> dict:
    """One HA drill (``ha_drills``) over a fresh store seeded with
    ``preempt_mix(2000, 40, seed=1)``: leader A runs one cycle (period one
    hour) under the drill's fault, then dies or loses its lease; standby B
    takes over, reconciles the journal in ``start()`` and runs its loop
    (period ``HA_DRILL_B_PERIOD``) for ``DRILL_CYCLES`` cycles. Returns the
    drill's record with the store's final placements under ``final``."""
    from kube_batch_tpu_torch import faults, metrics, models
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.cache import ClusterStore

    store = ClusterStore()
    tt.seed_store(store, *models.preempt_mix_objects(*DRILL_WORLD[:2], seed=DRILL_WORLD[2]))
    binds = StoreBinds(store)
    wal = os.path.join(tmp, f"{kind}-{device}.wal")
    lock = os.path.join(tmp, f"{kind}-{device}.lock") if kind == "a_flock_pair" else None
    pair = HaPair(store, conf, device, wal, url, f"kb-{kind}-{device}", HA_DRILL_LEASE, lock_file=lock)
    kill = kind in HA_DRILL_KILL_AFTER
    binder = DyingBinder(store, HA_DRILL_KILL_AFTER[kind]) if kill else None
    append_failed = metrics.journal_records.value({"state": "append_failed"})
    rec: dict = {"drill": kind}
    try:
        if kind == "c_journal_append":
            faults.registry.arm("journal.append", count=1)
        pair.start_leader(3600.0, binder=binder)
        deadline = time.monotonic() + 120
        while not pair.log_a.cycles and not pair.log_a.errors and time.monotonic() < deadline:
            time.sleep(0.01)
        if kill:
            if not binder.killed.wait(60):
                raise AssertionError(f"{kind}: the leader did not reach its kill")
        else:
            settle(pair.srv_a.cache)
        faults.registry.reset()
        pair.log_a.check(f"ha_drills {kind} (leader)")
        rec["leader_binds"] = len(binds.at)
        if kind == "c_journal_append":
            rec["append_failed"] = metrics.journal_records.value({"state": "append_failed"}) - append_failed
            rec["leader_outstanding"] = len(pair.srv_a.journal.outstanding())
            if rec["append_failed"] != rec["leader_binds"] or rec["leader_outstanding"]:
                raise AssertionError(f"{kind}: {rec}")
        if kind == "a_flock_pair":
            time.sleep(0.3)
            if pair.acquired_b.is_set():
                raise AssertionError(f"{kind}: the standby took a held lock")
        if kind == "b_lease_renew":
            faults.registry.arm("lease.renew")
            armed_at = time.perf_counter()
            if not pair.lost.wait(HA_DRILL_LEASE["renew_deadline"] * 4):
                raise AssertionError(f"{kind}: on_lost did not fire")
            faults.registry.reset()  # run() would have exited; the standby's tries succeed again
            rec["lost_after_s"] = pair.lost_at - armed_at
            rec["holder_at_on_lost"] = pair.holder_at_lost
            if pair.holder_at_lost != "":
                raise AssertionError(f"{kind}: the lease was held by {pair.holder_at_lost!r} when on_lost ran")
            t_gone = pair.lost_at
            pair.srv_a.stop()
        elif kind == "c_journal_append":
            t_gone = time.perf_counter()
            pair.srv_a.stop()
            pair.el_a.release()  # a graceful hand-off
        else:
            t_gone = time.perf_counter()
            pair.kill_leader()
        if kind == "f_half_bound_gang_rollback":
            rec["deleted_node"] = delete_a_target_node(store, wal)
        arm = {"d_journal_replay": ("journal.replay", {"count": 1}),
               "e_reconcile_scan": ("reconcile.scan", {"probability": 0.002, "count": 1, "seed": 7})}.get(kind)
        pair.start_standby(HA_DRILL_B_PERIOD, timeout=HA_DRILL_LEASE["lease_duration"] + 10, arm=arm)
        rec["takeover_s"] = pair.acquired_b_at - t_gone
        if kind == "b_lease_renew" and rec["takeover_s"] >= HA_DRILL_LEASE["lease_duration"]:
            raise AssertionError(f"{kind}: the standby waited out the lease ({rec['takeover_s']} s)")
        pair.wait_b_cycles(DRILL_CYCLES, 120)
        settle(pair.srv_b.cache)
        pair.log_b.check(f"ha_drills {kind} (standby)")
        (report,) = pair.reports
        rec["reconcile_report"] = report.as_dict()
        rec["reconcile_s"] = pair.reconcile_s
        if pair.violations:
            raise AssertionError(f"{kind}: mutation detector around reconciliation: {pair.violations[:3]}")
        rec["outstanding_after"] = len(pair.srv_b.journal.outstanding())
        rec["standby_cycles"] = [{"run_once_s": c["run_once_s"], "pending": c["pending"], "b1_launches": c["b1_launches"]}
                                 for c in pair.log_b.cycles]
        rec["final"] = placements(store)
        rec.update(store_checks(store))
        rec["bound_twice"] = sorted(k for k, n in binds.counts.items() if n > 1)
        min_member = {pg.name: pg.spec.min_member for pg in store.list("podgroups")}
        rec["launches"] = pair.launches()
    finally:
        faults.registry.reset()
        pair.stop()
    rep = rec["reconcile_report"]
    expect = {
        "d_journal_replay": rep["aborted"] and not rep["scanned"],
        "e_reconcile_scan": rep["aborted"] and 0 < rep["scanned"],
        "f_half_bound_gang_rollback": not rep["aborted"] and rep["gangs_rolled_back"] and rep["rolled_back"] > 0,
    }.get(kind, not rep["aborted"] and not rep["rolled_back"] and not rep["conflicts"])
    if not expect:
        raise AssertionError(f"{kind}: reconciliation {rep}")
    if kind == "f_half_bound_gang_rollback":
        # the pods bound twice are the rolled-back gangs' alone (bound by
        # reconciliation, unbound by the rollback, bound again by the
        # standby's loop), and one such gang ends whole again
        gangs = {g.split("/")[1] for g in rep["gangs_rolled_back"]}

        def gang(key: str) -> str:  # "default/job-00005-t17" -> "job-00005"
            return key.split("/")[1].rsplit("-t", 1)[0]

        strays = [k for k in rec["bound_twice"] if gang(k) not in gangs]
        bound = {g: sum(1 for k, n in rec["final"].items() if n and gang(k) == g) for g in gangs}
        again = {gang(k) for k in rec["bound_twice"]}
        rec["rolled_back_gangs_bound_again"] = sorted(g for g in gangs if bound[g] >= min_member[g] and g in again)
        if strays or not rec["rolled_back_gangs_bound_again"]:
            raise AssertionError(f"{kind}: bound twice outside the rolled-back gangs: {strays[:3]}; the "
                                 f"rolled-back gangs' bound members {bound}, whole at "
                                 f"{ {g: min_member[g] for g in gangs} }; reconciliation {rep}")
    elif rec["bound_twice"]:
        raise AssertionError(f"{kind}: pods bound twice: {rec['bound_twice'][:3]}")
    rec["bound_twice"] = len(rec["bound_twice"])
    return rec


def delete_a_target_node(store, wal: str) -> str:
    """Drill (f): while the leader is down, delete the target node of an
    orphaned member of the first gang (in seq order) that has a member
    bound in the store and an earlier orphan on another node, so that the
    gang cannot complete and reconciliation undoes that earlier orphan's
    re-dispatch. The node must hold no pod: a pod bound to a node that no
    longer exists makes every later cycle raise ``KeyError: ''`` in the
    scan actions, in the JAX package as in the port (ROADMAP C)."""
    from kube_batch_tpu_torch.apis.types import GROUP_NAME_ANNOTATION_KEY
    from kube_batch_tpu_torch.recovery import WriteIntentJournal

    pods = store.list("pods")
    occupied = {p.node_name for p in pods if p.node_name}
    bound = {f"{p.namespace}/{p.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY)}" for p in pods if p.node_name}
    by_gang: dict[str, list] = {}
    for intent in WriteIntentJournal.replay(wal).orphans:
        by_gang.setdefault(intent.gang, []).append(intent)
    for gang, members in by_gang.items():
        if gang not in bound:
            continue
        for intent in members[1:]:
            if intent.node not in occupied and intent.node != members[0].node:
                store.delete_node(intent.node)
                return intent.node
    raise AssertionError("no half-bound gang has an orphan aimed at an empty node")


HA_DRILLS = ("a_flock_pair", "b_lease_renew", "c_journal_append", "d_journal_replay", "e_reconcile_scan",
             "f_half_bound_gang_rollback")


def ha_drills(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``ha_drills``: each drill of ``HA_DRILLS`` (see ``ha_drill``) on the
    card and again on the CPU (the kernel's plain version), each run on a
    fresh store; the card's run must end equal to the CPU's, every gang
    bound whole or not at all, no node past its allocatable. (a) flock
    pair; (b) ``lease.renew``: renewals fail, the lease is released before
    ``on_lost`` and the standby takes over at once; (c) ``journal.append``:
    the leader's bulk statement goes out unjournaled and lands; (d)
    ``journal.replay`` at takeover and (e) ``reconcile.scan`` part-way:
    reconciliation aborts after the leader died mid-``bind_many``, and the
    standby's loop heals; (f) the leader dies mid-``bind_many`` and a target
    node of an orphaned gang is deleted: the gang rolls back and the
    standby's loop binds it elsewhere."""
    import tempfile

    from kube_batch_tpu_torch import metrics, native

    on_card = device == "cuda"
    conf = conf_file(base=PIPELINE_CONF, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
    cpu_conf = conf_file(base=PIPELINE_CONF, min_device_pairs=0, device="cpu")
    threads_before = set(threading.enumerate())
    arbiter, url = arbiter_server()
    tmp = tempfile.mkdtemp(prefix="kbt-ha-drills-")
    t0 = time.perf_counter()
    out = {"phase": "ha_drills", "world": "preempt_mix(%d, %d, seed=%d)" % DRILL_WORLD, "lease": HA_DRILL_LEASE,
           "kill_after_binds": HA_DRILL_KILL_AFTER}
    launches = [0, 0]
    try:
        for kind in HA_DRILLS:
            before = {"degraded": sum(metrics.degraded_cycles.samples().values()),
                      "breakers": sum(metrics.breaker_transitions.samples().values()),
                      "native": sum(native.fallbacks.values())}
            rec = ha_drill(kind, device, url, conf, tmp)
            after = {"degraded": sum(metrics.degraded_cycles.samples().values()),
                     "breakers": sum(metrics.breaker_transitions.samples().values()),
                     "native": sum(native.fallbacks.values())}
            if after != before:
                raise AssertionError(f"{kind}: degraded outside the drill's intent: {before} -> {after}")
            if on_card:
                cpu = ha_drill(kind, "cpu", url, cpu_conf, tmp)
                if cpu["final"] != rec["final"]:
                    moved = sum(1 for k in rec["final"] if cpu["final"].get(k) != rec["final"][k])
                    raise AssertionError(f"{kind}: {moved} pods end elsewhere than the same drill on the CPU")
                launches[0] += rec["launches"][0]
                launches[1] += rec["launches"][1]
            final = rec.pop("final")
            rec["pods_bound"] = sum(1 for v in final.values() if v)
            rec["equal_to_cpu_drill"] = True
            out[kind] = rec
    finally:
        arbiter.stop()
    join_new_threads(threads_before, "ha_drills")
    bound = {out[k]["pods_bound"] for k in ("a_flock_pair", "b_lease_renew", "c_journal_append")}
    if len(bound) != 1:
        raise AssertionError(f"the undisturbed-path drills end with different bind counts: {bound}")
    if on_card and (launches[0] < 2 * len(HA_DRILLS) or launches[1]):
        raise AssertionError(f"{launches[0]} B1 and {launches[1]} B2 launches over the drills")
    out.update(s=time.perf_counter() - t0, b1_launches=launches[0], b2_launches=launches[1])
    return out, tuple(launches)


# -- the port as a federation -------------------------------------------------

FED_SHARDS = 2  # the compose file's federation profile: KBT_FEDERATION=0/2 and 1/2, KBT_SHARD_KEY=gang
FED_WAIT_S = 300.0  # the limit on the store showing every pending pod of the world bound once
FED_START_S = 120.0  # the limit on a shard process answering /healthz
SCALEOUT_WORLD = (5_000, 10, 5_000)  # bench.py federation_scaleout_row: gangs x members on nodes
SCALEOUT_SHARDS = 4
# the scale-out world's depth is halved for the script's clock (2,500 gangs
# on 2,500 nodes): its drain is enqueue's O(jobs^2) pop (ROADMAP C1)
SCALEOUT_CUT = 2
SCALEOUT_WAIT_S = 300.0
FED_DRILL_WORLD = (6, 3, 8)  # federation.smoke's world: gangs x members on nodes of 8 cpu
FED_DRILLS = ("a_kill_one", "b_stale_assign", "c_txn_batch", "d_partition", "e_adopt_fails_once",
              "f_handoff", "g_lease_flap", "h_v1_server")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"<no log: {e}>"


def labelled(values: dict, name: str) -> dict:
    """``name{labels}`` samples of an exposition, by their label string."""
    prefix = f"kube_batch_tpu_{name}"
    return {k[len(prefix):]: v for k, v in values.items() if k == prefix or k.startswith(prefix + "{")}


def shard_trace(spans: list[dict]) -> dict:
    """A shard process's cycles, read from its flight recorder
    (``/debug/trace``): each cycle's span durations, the first cycle with
    pending tasks in full, the solve rungs, and the coalesced batches."""
    by_trace: dict[str, list] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    cycles = []
    for group in by_trace.values():
        root = next((s for s in group if s["name"] == "cycle"), None)
        if root is None:
            continue
        dur = {}
        for s in group:
            dur.setdefault(s["name"], []).append(s["dur_us"] / 1e6)
        solve = [s for s in group if s["name"] == "solve"]
        enc = [s for s in group if s["name"] == "encode"]
        batches = [s for s in group if s["name"] == "txn.batch"]
        cycles.append({
            "start_us": root["start_us"], "run_once_s": root["dur_us"] / 1e6,
            "tasks": enc[0]["attrs"].get("tasks") if enc else 0,
            "warm_fraction": enc[0]["attrs"].get("warm_fraction") if enc else None,
            "tiers": [s["attrs"].get("tier") for s in solve],
            "split_s": {k: sum(v) for k, v in dur.items() if k != "cycle"},
            "txn_batches": [{k: b["attrs"].get(k) for k in ("gangs", "pods", "outcome", "conflicts")}
                            for b in batches],
            "gang_binds": len(dur.get("gang.bind", [])),
        })
    cycles.sort(key=lambda c: c["start_us"])
    return {"cycles": cycles}


class ShardProcess:
    """One ``python -m kube_batch_tpu_torch.server --store-backend URL``
    process: shard ``i`` of ``n`` (``KBT_FEDERATION``), keyed by gang, on
    the card unless ``conf`` says ``device: cpu``, traced (``KBT_TRACE=1``,
    the flight recorder read over ``/debug/trace``, no dumps), its log in a
    file."""

    def __init__(self, i: int, n: int, url: str, conf: str, logdir: str) -> None:
        self.i = i
        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.log_path = os.path.join(logdir, f"federation-shard-{i}.log")
        env = dict(os.environ, KBT_FEDERATION=f"{i}/{n}", KBT_SHARD_KEY="gang", KBT_TRACE="1",
                   KBT_FLIGHT_RECORDER="0", PYTHONUNBUFFERED="1")
        root = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self._log = open(self.log_path, "w")
        self.t_start = time.perf_counter()
        self.t_wall = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kube_batch_tpu_torch.server", "--store-backend", url, "--scheduler-conf", conf,
             "--listen-address", f"127.0.0.1:{self.port}"],
            cwd=root, env=env, stdout=self._log, stderr=subprocess.STDOUT)
        self.exit_code = None

    def wait_up(self, deadline: float) -> float:
        """Seconds from the start to the first 200 on ``/healthz``."""
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError(f"shard {self.i} exited {self.proc.returncode} at start:\n{tail(self.log_path)}")
            try:
                if http(self.base, "GET", "/healthz")[0] == 200:
                    return time.perf_counter() - self.t_start
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError(f"shard {self.i} did not answer /healthz within {FED_START_S} s:\n{tail(self.log_path)}")

    def scrape(self) -> dict:
        code, text = http(self.base, "GET", "/metrics")
        if code != 200:
            raise AssertionError(f"shard {self.i} /metrics answered {code}")
        return exposition_values(text)

    def spans(self) -> list[dict]:
        code, text = http(self.base, "GET", "/debug/trace")
        if code != 200:
            raise AssertionError(f"shard {self.i} /debug/trace answered {code}")
        return json.loads(text)["spans"]

    def stop(self, timeout: float = 60.0) -> int:
        """SIGINT (the server's own shutdown: the loop, the slot lease
        released, the backend's pump), then wait; a process that does not
        end is killed and fails the phase."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
                self._log.close()
                raise AssertionError(f"shard {self.i} did not end on SIGINT:\n{tail(self.log_path)}") from None
        self._log.close()
        self.exit_code = self.proc.returncode
        return self.exit_code


def federation_phase(device: str = "cuda", cut: int = 1, want: dict | None = None) -> tuple[dict, tuple[int, int]]:
    """``federation_50k_5k``: the shipped compose topology's ``federation``
    profile. The store is a ``SchedulerServer`` in this process (an
    unmatched scheduler name: its loop solves nothing) over a
    ``ClusterStore`` seeded with ``preempt_mix(50_000, 5_000)`` (59,501
    objects, 2,000 Pending gangs); two shard processes, ``python -m
    kube_batch_tpu_torch.server --store-backend URL`` with
    ``KBT_FEDERATION=0/2`` and ``1/2`` and ``KBT_SHARD_KEY=gang``, each on
    ``cuda:0`` with the twin pipeline conf, mirror it over wire v2 and
    schedule their halves. Every pending pod must bind exactly once (a
    store handler counts ``""`` -> node transitions), ``federation.fsck``
    must be clean, the bound set must be the FakeCache cycle's, no shard
    cycle may degrade (its solve spans' rung, its exposition's degraded
    cycles, breaker transitions and fault injections, its log's native
    fallbacks), and both processes must end on SIGINT with code 0."""
    from kube_batch_tpu_torch import federation, metrics, models
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.cache import ClusterStore
    from kube_batch_tpu_torch.server import SchedulerServer

    on_card = device == "cuda"
    pods, nodes = SERVER_WORLD[0] // cut, SERVER_WORLD[1] // cut
    conf = conf_file(base=PIPELINE_CONF, device="cuda" if on_card else "cpu")
    if want is None:
        twin, twin_cache, _ = pipeline_cycle("federation_twin", models.preempt_mix(pods, nodes), conf, device)
        want = dict(twin_cache.binder.binds)
        del twin_cache
    world = models.preempt_mix_objects(pods, nodes)
    store = ClusterStore()
    t0 = time.perf_counter()
    tt.seed_store(store, *world)
    ingest_s = time.perf_counter() - t0
    pending = {f"{p.namespace}/{p.name}" for p in world[0] if not p.node_name}
    gangs = len(world[2])
    binds = StoreBinds(store)
    threads_before = set(threading.enumerate())
    arbiter = SchedulerServer(scheduler_name="store-arbiter", listen_address="127.0.0.1:0", schedule_period=3600.0,
                              scheduler_conf=conf_file(base=PIPELINE_CONF, device="cpu"), store=store)
    arbiter.start()
    url = f"http://127.0.0.1:{arbiter.listen_port}"
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(logdir, exist_ok=True)
    txn0 = metrics.store_backend_txn_batch.snapshot()
    wake0 = dict(metrics.watch_longpoll_wakeups.samples())
    shards: list[ShardProcess] = []
    rec = {"phase": "federation_50k_5k", "pods": pods, "nodes": nodes, "gangs": gangs, "shards": FED_SHARDS,
           "store_objects": sum(len(w) for w in world), "ingest_s": ingest_s, "shard_key": "gang"}
    failed = None
    try:
        t_start = time.perf_counter()
        shards = [ShardProcess(i, FED_SHARDS, url, conf, logdir) for i in range(FED_SHARDS)]
        deadline = time.monotonic() + FED_START_S
        up_s = [s.wait_up(deadline) for s in shards]
        deadline = time.monotonic() + FED_WAIT_S
        while time.monotonic() < deadline and len(binds.at) < len(pending):
            if any(s.proc.poll() is not None for s in shards):
                break
            time.sleep(0.05)
        all_bound_s = time.perf_counter() - t_start
        dead = [(s.i, s.proc.returncode) for s in shards if s.proc.poll() is not None]
        if dead:
            raise AssertionError(f"shard processes ended early: {dead}")
        if len(binds.at) < len(pending):
            raise AssertionError(f"{len(binds.at)} of {len(pending)} pending pods bound within {FED_WAIT_S} s")
        twice = {k: v for k, v in binds.counts.items() if v > 1}
        if twice:
            raise AssertionError(f"{len(twice)} pods bound more than once: {list(twice.items())[:3]}")
        if set(binds.at) != pending:
            raise AssertionError(f"bound {len(set(binds.at) - pending)} pods that were not pending")
        if set(binds.at) != set(want):
            raise AssertionError(f"the bound set differs from the FakeCache cycle's: {len(binds.at)} against "
                                 f"{len(want)}, {len(set(want) - set(binds.at))} missing")
        time.sleep(1.5)  # one more period: the shards' last dispatches settle and their idle cycles run
        violations = federation.fsck(store, shard_key="gang")
        if violations:
            raise AssertionError(f"fsck: {violations[:5]}")
        checks = store_checks(store)
        per_shard = []
        for s in shards:
            values, trace = s.scrape(), shard_trace(s.spans())
            conflicts = labelled(values, "federation_conflicts_total")
            wire_bytes = labelled(values, "store_backend_bytes_total")
            rtt = labelled(values, "store_backend_rtt_seconds_sum")
            rtt_n = labelled(values, "store_backend_rtt_seconds_count")
            bad = {name: labelled(values, name) for name in (
                "degraded_cycles_total", "breaker_transitions_total", "fault_injections_total")}
            bad = {k: {lk: v for lk, v in d.items() if v} for k, d in bad.items()}
            if any(bad.values()):
                raise AssertionError(f"shard {s.i} degraded: {bad}")
            with open(s.log_path) as f:
                native_fallbacks = sum(1 for line in f if "using the Python twin" in line)
            if native_fallbacks:
                raise AssertionError(f"shard {s.i} fell back from the native loops:\n{tail(s.log_path)}")
            cycles = trace["cycles"]
            working = [c for c in cycles if c["tasks"]]
            if not working:
                raise AssertionError(f"shard {s.i} ran no cycle with pending tasks")
            wrong = [c["tiers"] for c in working if c["tiers"] != ["fused"]]
            if on_card and wrong:
                raise AssertionError(f"shard {s.i} solved below the fused rung: {wrong}")
            by_codec: dict[str, float] = {}
            for k, v in wire_bytes.items():
                codec = k.split('codec="')[1].split('"')[0]
                by_codec[codec] = by_codec.get(codec, 0.0) + v
            # the negotiation read and the lease verbs are JSON by design;
            # the list, the watch and the binds ride the binary codec
            if by_codec.get("binary", 0.0) <= by_codec.get("json", 0.0):
                raise AssertionError(f"shard {s.i} moved {by_codec} bytes: wire v2's binary codec not negotiated")
            first = working[0]
            per_shard.append({
                "shard": f"{s.i}/{FED_SHARDS}", "up_s": up_s[s.i],
                "first_cycle_after_s": first["start_us"] / 1e6 - s.t_wall,
                "list_rtt_s": {k: v for k, v in rtt.items() if "list" in k},
                "rtt_s": sum(rtt.values()), "requests": sum(rtt_n.values()),
                "cycle_1": first, "cycles": len(cycles), "working_cycles": len(working),
                "b1_launches": sum(c["tiers"].count("fused") for c in cycles) if on_card else 0,
                "conflicts": conflicts, "bind_retries": labelled(values, "bind_retries_total").get("", 0.0),
                "wire_bytes": wire_bytes, "bytes_by_codec": by_codec,
                "warm_fractions": [c["warm_fraction"] for c in working],
            })
        txn1 = metrics.store_backend_txn_batch.snapshot()
        wake1 = dict(metrics.watch_longpoll_wakeups.samples())
        batches = txn1["count"] - txn0["count"]
        if batches < FED_SHARDS:
            raise AssertionError(f"the store saw {batches} coalesced txn batches: wire v2 was not negotiated")
        total_bytes = sum(sum(p["wire_bytes"].values()) for p in per_shard)
        rec.update(
            all_bound_s=all_bound_s, binds=len(binds.at), exactly_once=True, fsck_violations=[],
            equal_to_fakecache_bound_set=True, protocol=2, **checks,
            txn_batches=batches, txn_batch_mean=(txn1["sum"] - txn0["sum"]) / batches,
            longpoll_wakeups={str(dict(k)): v - wake0.get(k, 0) for k, v in wake1.items()},
            wire_bytes_per_bind=total_bytes / len(binds.at), shard=per_shard,
            b1_launches=sum(p["b1_launches"] for p in per_shard),
        )
    except Exception as e:  # noqa: BLE001 - raised below, after every process is stopped
        failed = e
    finally:
        codes = []
        for s in shards:
            try:
                codes.append(s.stop())
            except AssertionError as e:
                failed = failed or e
                codes.append(None)
        arbiter.stop()
    if failed is None and codes != [0] * len(shards):
        failed = AssertionError(f"shard processes exited {codes}")
    if failed is not None:
        logs = "\n".join(f"--- shard {s.i} (exit {s.exit_code}) ---\n{tail(s.log_path)}" for s in shards)
        raise AssertionError(f"{failed}\n{logs}") from failed
    join_new_threads(threads_before, "federation_50k_5k")
    rec["exit_codes"] = codes
    if on_card and rec["b1_launches"] < FED_SHARDS:
        raise AssertionError(f"{rec['b1_launches']} B1 launches over {FED_SHARDS} shards")
    if cut > 1:
        rec["reduced"] = {"pods": [SERVER_WORLD[0], pods], "nodes": [SERVER_WORLD[1], nodes]}
    # the shards are processes of their own: their launches are read from
    # their solve spans, not from this process's counters
    return rec, (rec["b1_launches"], 0)


def scaleout_conf(device: str) -> str:
    """bench.py federation_scaleout_row's conf: ``enqueue, torch_allocate``
    with priority, gang, conformance, predicates and nodeorder, the size
    floor off."""
    from kube_batch_tpu_torch import federation
    from kube_batch_tpu_torch.ops import nvcc

    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    return federation.write_conf(device, bulk=True, directory=nvcc.BUILD_DIR)


def seed_scaleout(store, gangs: int, members: int, nodes: int) -> None:
    from kube_batch_tpu_torch import testing as tt

    store.create_queue(tt.build_queue("default"))
    for i in range(nodes):
        store.create_node(tt.build_node(f"n{i}", tt.build_resource_list(cpu=16, memory="32Gi", pods=32)))
    for g in range(gangs):
        store.create_pod_group(tt.build_pod_group(f"f{g}", min_member=members))
        for m in range(members):
            store.create_pod(tt.build_pod(name=f"f{g}-p{m}", group_name=f"f{g}",
                                          req=tt.build_resource_list(cpu=1, memory="1Gi")))


def scaleout_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``federation_scaleout_50k_5k``: bench.py's ``federation_scaleout_row``
    world (5,000 gangs x 10 pods of 1 cpu / 1Gi on 5,000 nodes of 16 cpu /
    32Gi / 32 pods, gangs and nodes divided by ``cut``) and conf at N = 4:
    four ``FederatedCache`` +
    ``Scheduler`` threads over one ``ClusterStore`` (``shard_key="gang"``,
    period 0.02 s, inline writes), each solving on ``cuda:0``. Every pod
    must bind exactly once within 300 s and ``fsck`` must be clean; each
    shard's cycles solve on the fused rung."""
    from kube_batch_tpu_torch import federation, metrics
    from kube_batch_tpu_torch.cache import ClusterStore
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.scheduler import Scheduler

    gangs, members, nodes = SCALEOUT_WORLD[0] // cut, SCALEOUT_WORLD[1], SCALEOUT_WORLD[2] // cut
    total = gangs * members
    conf = scaleout_conf(device)
    store = ClusterStore()
    t0 = time.perf_counter()
    seed_scaleout(store, gangs, members, nodes)
    ingest_s = time.perf_counter() - t0
    binds = StoreBinds(store)

    def conflicts() -> dict:
        return {o: metrics.federation_conflicts.value({"outcome": o}) for o in ("clean", "won", "retried", "lost")} | {
            "bind_retries": metrics.bind_retries.value()}

    before = conflicts()
    t0 = time.perf_counter()
    caches = [federation.FederatedCache(store, shard=i, shards=SCALEOUT_SHARDS, shard_key="gang")
              for i in range(SCALEOUT_SHARDS)]
    cache_sync_s = time.perf_counter() - t0
    logs, threads = [], []
    stop = threading.Event()
    threads_before = set(threading.enumerate())
    b1_0, b2_0 = fs.fused_solve.launches, bs.block_step.launches
    t_start = time.perf_counter()
    for i, cache in enumerate(caches):
        sched = Scheduler(cache, scheduler_conf=conf, schedule_period=0.02)
        # the conf's action objects are the process's (as in the JAX
        # package), so their last_* records would be whichever shard ran
        # last: each shard gets its own, and its record is its own
        sched.actions = [type(a)() for a in sched.actions]
        logs.append(CycleLog(sched, device))
        t = threading.Thread(target=sched.run, args=(stop,), kwargs={"device": "cuda:0" if device == "cuda" else None},
                             name=f"kb-fed-{i}", daemon=True)
        t.start()
        threads.append(t)
    try:
        deadline = time.monotonic() + SCALEOUT_WAIT_S
        while time.monotonic() < deadline and len(binds.at) < total and not any(lg.errors for lg in logs):
            time.sleep(0.01)
        drain_s = time.perf_counter() - t_start
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        for c in caches:
            c.stop()  # the loop started each cache's write and resync pools
    join_new_threads(threads_before, "federation_scaleout_50k_5k")
    for i, lg in enumerate(logs):
        lg.check(f"federation_scaleout_50k_5k shard {i}")
    if len(binds.at) < total:
        raise AssertionError(f"{len(binds.at)} of {total} pods bound within {SCALEOUT_WAIT_S} s")
    twice = {k: v for k, v in binds.counts.items() if v > 1}
    if twice:
        raise AssertionError(f"{len(twice)} pods bound more than once")
    violations = federation.fsck(store, shard_key="gang")
    if violations:
        raise AssertionError(f"fsck: {violations[:5]}")
    after = conflicts()
    b1, b2 = fs.fused_solve.launches - b1_0, bs.block_step.launches - b2_0
    per_shard = []
    for i, lg in enumerate(logs):
        working = [c for c in lg.cycles if c["pending"]]
        per_shard.append({
            "shard": f"{i}/{SCALEOUT_SHARDS}", "cycles": len(lg.cycles), "working_cycles": len(working),
            # one fused solve, one launch: this world pauses for no host step
            "b1_launches": sum(1 for c in working if c["last_solver_tier"] == "fused"),
            "warm_fraction": [c["torch_allocate"].get("warm_fraction") for c in working],
            "run_once_s": [c["run_once_s"] for c in working],
            "pending": [c["pending"] for c in working],
            "encode_s": [c["torch_allocate"].get("encode_s") for c in working],
            "split_s": [{k: v for k, v in c["cycle"].items() if k.endswith("_s")} for c in working],
            "torch_allocate_s": [{k: v for k, v in c["torch_allocate"].items() if k.endswith("_s")}
                                 for c in working],
        })
    if device == "cuda" and (sum(p["b1_launches"] for p in per_shard) != b1 or b2 or b1 < SCALEOUT_SHARDS):
        raise AssertionError(f"{b1} B1 launches (shards: {[p['b1_launches'] for p in per_shard]}), {b2} B2")
    rec = {
        "phase": "federation_scaleout_50k_5k", "gangs": gangs, "members": members, "nodes": nodes, "pods": total,
        "shards": SCALEOUT_SHARDS, "ingest_s": ingest_s, "cache_sync_s": cache_sync_s, "drain_s": drain_s,
        "binds_per_s": total / drain_s, "conflicts": {k: after[k] - before[k] for k in after},
        "exactly_once": True, "fsck_violations": [], "shard": per_shard, "b1_launches": b1, "b2_launches": b2,
        **store_checks(store),
    }
    if cut > 1:
        rec["reduced"] = {"gangs": [SCALEOUT_WORLD[0], gangs], "nodes": [SCALEOUT_WORLD[2], nodes]}
    return rec, (b1, b2)


def fed_drill(kind: str, device: str, tmp: str) -> dict:
    """One federation drill over ``federation.smoke``'s world (6 gangs x 3
    pods of 1 cpu on 8 nodes), the bulk conf on ``device``; the schedulers'
    cycles run one after another (``run_once``), so the end is the same on
    the card and the CPU. Returns the drill's outcome (its ``final``
    placements included) and the B1 launches of its cycles."""
    from kube_batch_tpu_torch import faults, federation, metrics
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.cache import ClusterStore, LoopbackBackend
    from kube_batch_tpu_torch.cache.store import LEASES
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.server import SchedulerServer

    gangs, members, n_nodes = FED_DRILL_WORLD
    total = gangs * members
    conf = federation.write_conf(device, bulk=True, directory=tmp)
    b1_0 = fs.fused_solve.launches
    fired0 = dict(metrics.fault_injections.samples())
    out: dict = {}
    servers: list = []

    def counters() -> dict:
        return {**{o: metrics.federation_conflicts.value({"outcome": o}) for o in ("clean", "won", "retried", "lost")},
                "bind_retries": metrics.bind_retries.value(),
                **{f"adopt_{k[0][1]}": v for k, v in metrics.shard_adoptions.samples().items()},
                **{f"handoff_{k[0][1]}": v for k, v in metrics.shard_handoffs.samples().items()},
                "txn_batches": metrics.store_backend_txn_batch.snapshot()["count"]}

    def store_server(wire_protocol: int = 2):
        store = ClusterStore()
        federation._seed_world(store, gangs, members, n_nodes)
        srv = SchedulerServer(scheduler_name="store-arbiter", listen_address="127.0.0.1:0", schedule_period=3600.0,
                              scheduler_conf=conf_file(base=PIPELINE_CONF, device="cpu"), store=store,
                              wire_protocol=wire_protocol)
        srv.start()
        servers.append(srv)
        return store, f"http://127.0.0.1:{srv.listen_port}"

    def slot_pair(store):
        caches, mgrs, scheds = [], [], []
        for i in range(2):
            cache = federation.FederatedCache(store, shard=i, shards=2, shard_key="gang")
            mgr = federation.ShardSlotManager(store, cache, identity=f"mgr-{i}", lease_s=60.0, renew_s=1.0,
                                              adopt=True, journal_dir=tmp, grace_s=0.0, rebalance=0)
            store.try_acquire_lease(federation.slot_lease_name(i), mgr.identity, mgr.lease_s)
            mgr._set_owned({i})
            caches.append(cache)
            mgrs.append(mgr)
            scheds.append(Scheduler(cache, scheduler_conf=conf))
        return caches, mgrs, scheds

    def drive(scheds, store, backends=(), rounds: int = 6) -> None:
        for _ in range(rounds):
            for b in backends:
                b.pump()
            for s in scheds:
                s.run_once()
            for b in backends:
                b.pump()
            if sum(1 for p in store.list("pods") if p.node_name) >= total:
                return

    c0 = counters()
    try:
        if kind == "a_kill_one":
            r = federation.smoke_kill_one(device=device, bulk=True)
            out = {k: r[k] for k in ("ok", "pods", "bound", "victim_slot", "victim_gangs", "double_owned",
                                     "exactly_once", "double_binds", "fsck_violations", "union_parity")}
            out["timing"] = {k: r[k] for k in ("takeover_s", "mttr_s", "takeover_window_s",
                                               "unowned_window_observed")}
            if not r["ok"]:
                raise AssertionError(f"a_kill_one: {r}")
            out["final"] = {}
            out["pods_bound"] = r["bound"]
        else:
            armed = None
            if kind == "b_stale_assign":
                store = ClusterStore()
                federation._seed_world(store, gangs, members, n_nodes)
                # a placement on every node: a stale version conflicts wherever a gang lands
                for i in range(n_nodes):
                    store.create_pod(tt.build_pod(name=f"warm-{i}", req=tt.build_resource_list(cpu=1),
                                                  scheduler_name="elsewhere"))
                    store.conditional_bind_many([("default", f"warm-{i}", f"n{i}")], store.version)
                binds = StoreBinds(store)
                cache = federation.FederatedCache(store, shard=0, shards=1, shard_key="gang")
                armed = "federation.stale_assign"
                faults.registry.arm(armed, count=1)
                drive([Scheduler(cache, scheduler_conf=conf)], store)
            elif kind in ("c_txn_batch", "d_partition", "h_v1_server"):
                store, url = store_server(1 if kind == "h_v1_server" else 2)
                binds = StoreBinds(store)
                n = 2 if kind == "h_v1_server" else 1
                backends = [LoopbackBackend(url) for _ in range(n)]
                caches = [federation.FederatedCache(b, shard=i, shards=n, shard_key="gang",
                                                    staleness_fn=b.snapshot_age) for i, b in enumerate(backends)]
                scheds = [Scheduler(c, scheduler_conf=conf) for c in caches]
                out["negotiated"] = [[b._protocol, b._codec, b.supports_txn()] for b in backends]
                if kind == "c_txn_batch":
                    armed = "store.txn_batch"
                    faults.registry.arm(armed, count=1)
                elif kind == "d_partition":
                    armed = "federation.partition"
                    faults.registry.arm(armed, count=1)
                    store.create_pod_group(tt.build_pod_group("late", min_member=1))
                    store.create_pod(tt.build_pod(name="late-p0", group_name="late",
                                                  req=tt.build_resource_list(cpu=1, memory="512Mi")))
                    total += 1
                    out["partitioned_pump"] = backends[0].pump()
                    out["renegotiate"] = backends[0]._needs_negotiation
                    out["late_seen_before_heal"] = backends[0].get_pod("default", "late-p0") is not None
                    out["healed_pump_events"] = backends[0].pump() >= 1
                    out["late_seen_after_heal"] = backends[0].get_pod("default", "late-p0") is not None
                    out["negotiated_after_heal"] = [backends[0]._protocol, backends[0]._codec]
                drive(scheds, store, backends)
                for b in backends:
                    b.stop()
            else:
                store = ClusterStore()
                federation._seed_world(store, gangs, members, n_nodes)
                binds = StoreBinds(store)
                caches, mgrs, scheds = slot_pair(store)
                if kind == "e_adopt_fails_once":
                    store.release_lease(federation.slot_lease_name(0), "mgr-0")
                    mgrs[0]._set_owned(set())
                    scheds = scheds[1:]
                    armed = "shard.adopt"
                    faults.registry.arm(armed, count=1)
                    mgrs[1].step()
                    out["owned_after_failure"] = sorted(mgrs[1].owned_slots())
                    out["lease_after_failure"] = store.get(LEASES, federation.slot_lease_name(0)).holder_identity
                    mgrs[1].step()
                elif kind == "f_handoff":
                    store.release_lease(federation.slot_lease_name(1), "mgr-1")
                    mgrs[1]._set_owned(set())
                    mgrs[0].step()
                    out["adopted"] = sorted(mgrs[0].owned_slots())
                    out["handed_off"] = mgrs[0].handoff(1)
                    mgrs[1].step()
                    armed = "shard.handoff"
                    faults.registry.arm(armed, count=1)
                    out["failed_handoff_kept"] = not mgrs[1].handoff(1)
                elif kind == "g_lease_flap":
                    lease0 = store.get(LEASES, federation.slot_lease_name(0))
                    armed = "shard.lease_flap"
                    faults.registry.arm(armed, count=1)
                    mgrs[0].step()
                    mgrs[1].step()
                    mgrs[0].step()
                    lease1 = store.get(LEASES, federation.slot_lease_name(0))
                    out["holder"] = lease1.holder_identity
                    out["transitions"] = lease1.lease_transitions - lease0.lease_transitions
                out["owned"] = [sorted(m.owned_slots()) for m in mgrs]
                out["holders"] = [store.get(LEASES, federation.slot_lease_name(i)).holder_identity for i in range(2)]
                drive(scheds, store)
            fired = {str(dict(k)): v - fired0.get(k, 0) for k, v in metrics.fault_injections.samples().items()
                     if v != fired0.get(k, 0)}
            want_fired = {str({"point": armed}): 1.0} if armed else {}
            if fired != want_fired:
                raise AssertionError(f"{kind}: fault points fired {fired}, armed {want_fired}")
            final = placements(store)
            bound = {k for k, v in final.items() if v and not k.startswith("default/warm-")}
            if len(bound) != total:
                raise AssertionError(f"{kind}: {len(bound)} of {total} pods bound")
            twice = {k: v for k, v in binds.counts.items() if v > 1}
            if twice:
                raise AssertionError(f"{kind}: pods bound twice: {twice}")
            violations = federation.fsck(store, shard_key="gang")
            if violations:
                raise AssertionError(f"{kind}: fsck: {violations}")
            out.update(final=final, pods_bound=len(bound), exactly_once=True, fsck_violations=[], fired=fired,
                       **store_checks(store))
    finally:
        faults.registry.reset()
        for srv in servers:
            srv.stop()
    c1 = counters()
    out["counters"] = {k: v - c0.get(k, 0) for k, v in c1.items() if v != c0.get(k, 0)}
    out["b1_launches"] = fs.fused_solve.launches - b1_0
    return out


def federation_drills(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``federation_drills``: each drill of ``FED_DRILLS`` on the card and
    again on the CPU, ending equal (placements, exactly-once, ``fsck``, the
    adoption, handoff and conflict outcomes): (a) the kill drill, the owner
    dying mid-``bind_many`` (``smoke_kill_one``, 4 shards, 16 gangs x 2 on
    12 nodes, leases 1.0 / 0.25 s; which survivor adopts, and when, is a
    race, so its bound count and outcome are compared); (b)
    ``federation.stale_assign``: a conflict, a retry with a fresh version
    and a win; (c) ``store.txn_batch``: the coalesced batch degrades to
    per-gang writes; (d) ``federation.partition``: a pump round dropped,
    the next one renegotiates and delivers what the store made meanwhile;
    (e) ``shard.adopt`` fails once and the retry adopts; (f) a graceful
    handoff, then ``shard.handoff`` failing keeps the slot; (g)
    ``shard.lease_flap``: one renewal round dropped, no new holder; (h) a
    v2 client against a server pinned to v1. Only the armed point may
    fire."""
    import tempfile

    from kube_batch_tpu_torch import metrics, native

    on_card = device == "cuda"
    threads_before = set(threading.enumerate())
    t0 = time.perf_counter()
    out = {"phase": "federation_drills", "world": "gangs x members on nodes = %d x %d on %d" % FED_DRILL_WORLD}
    launches = 0
    for kind in FED_DRILLS:
        before = {"degraded": sum(metrics.degraded_cycles.samples().values()),
                  "breakers": sum(metrics.breaker_transitions.samples().values()),
                  "native": sum(native.fallbacks.values())}
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="kbt-fed-drill-") as tmp:
            rec = fed_drill(kind, device, tmp)
        rec["s"] = time.perf_counter() - t1
        after = {"degraded": sum(metrics.degraded_cycles.samples().values()),
                 "breakers": sum(metrics.breaker_transitions.samples().values()),
                 "native": sum(native.fallbacks.values())}
        if after != before:
            raise AssertionError(f"{kind}: degraded outside the drill's intent: {before} -> {after}")
        if on_card:
            with tempfile.TemporaryDirectory(prefix="kbt-fed-drill-") as tmp:
                cpu = fed_drill(kind, "cpu", tmp)
            # the kill drill's threads race: its conflict counts are timing, not outcome
            racy = ("s", "timing", "b1_launches") + (("counters",) if kind == "a_kill_one" else ())
            mine = {k: v for k, v in rec.items() if k not in racy}
            theirs = {k: v for k, v in cpu.items() if k not in racy}
            if mine != theirs:
                diff = sorted(k for k in set(mine) | set(theirs) if mine.get(k) != theirs.get(k))
                raise AssertionError(f"{kind}: the card's run ends unlike the CPU's in {diff}")
            if rec["b1_launches"] < 1:
                raise AssertionError(f"{kind}: no B1 launch on the card")
            launches += rec["b1_launches"]
        del rec["final"]
        rec["equal_to_cpu_drill"] = on_card
        out[kind] = rec
    join_new_threads(threads_before, "federation_drills")
    out.update(s=time.perf_counter() - t0, b1_launches=launches)
    return out, (launches, 0)


def federation_phases(device: str = "cuda", cut: int = 1, shared: dict | None = None) -> tuple[list[str], dict]:
    """The federation's phases: ``federation_50k_5k`` (two shard processes
    over a store of this process), ``federation_scaleout_50k_5k`` (four
    shard threads) and ``federation_drills``. Returns the failures and the
    launches of each phase's main path."""
    failures, launches = [], {}

    def processes():
        rec, launches["federation_50k_5k"] = federation_phase(device, cut, (shared or {}).get("want"))
        emit(rec)

    def scaleout():
        rec, launches["federation_scaleout_50k_5k"] = scaleout_phase(device, cut * SCALEOUT_CUT)
        emit(rec)

    def drills():
        rec, launches["federation_drills"] = federation_drills(device)
        emit(rec)

    run_phase(failures, "federation_50k_5k", processes)
    run_phase(failures, "federation_scaleout_50k_5k", scaleout)
    run_phase(failures, "federation_drills", drills, drill=True)
    return failures, launches


def server_phases(device: str = "cuda", cut: int = 1, shared: dict | None = None) -> tuple[list[str], dict]:
    """The process's phases: ``server_50k_5k`` (undisturbed),
    ``server_drills`` (they inject their faults), ``ha_failover_50k_5k``
    (the leader's death is no fault point: any degradation fails it) and
    ``ha_drills``. Returns the failures and the launches of each phase's
    main path."""
    failures, launches = [], {}
    shared = {} if shared is None else shared

    def server():
        rec, launches["server_50k_5k"] = server_phase(device, cut, shared)
        emit(rec)

    def drills():
        rec, launches["server_drills"] = server_drills(device)
        emit(rec)

    def failover():
        rec, launches["ha_failover_50k_5k"] = ha_failover_phase(device, cut, shared.get("want"))
        emit(rec)

    def ha():
        rec, launches["ha_drills"] = ha_drills(device)
        emit(rec)

    run_phase(failures, "server_50k_5k", server)
    run_phase(failures, "server_drills", drills, drill=True)
    run_phase(failures, "ha_failover_50k_5k", failover)
    run_phase(failures, "ha_drills", ha, drill=True)
    return failures, launches


# -- streaming and pipelined cycles ---------------------------------------------

# bench.py sustained_arrival_row at its defaults: resident gangs x members on
# nodes, then warm-up, probe and sustained gangs of ARRIVAL_MEMBERS pods
# arriving at STREAM_RATE pods/s, a node label flip every 10th sustained gang
STREAM_WORLD = (1_000, 100, 1_000)
STREAM_ARRIVALS = (2, 6, 40)  # warm-up, probe and sustained gangs
ARRIVAL_MEMBERS = 8
STREAM_RATE = 400.0  # offered pods/s of the sustained arrivals
STREAM_PERIOD_S = 60.0  # the backstop full cycle's period
STREAM_CONF = """
actions: "enqueue, torch_allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
actionArguments:
  torch_allocate:
    device: {device}
streaming: {streaming}
"""
PIPE_SESSIONS = 3  # measured sessions a column of pipelined_50k_5k, after one warm session each (bench.py's 5, cut for the clock)
STREAM_DRILL_NODES = 6  # the drills' store: nodes of 16 cpu, gangs of 1-cpu pods


def nearest_rank(values: list, p: float):
    """bench.py's percentile: nearest rank on the sorted sample."""
    import math

    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, min(len(vals) - 1, math.ceil(p / 100 * len(vals)) - 1))]


def write_text(text: str, name: str) -> str:
    """``text`` in a conf file beside the kernels' build (inside the checkout)."""
    import zlib

    from kube_batch_tpu_torch.ops import nvcc

    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    path = os.path.join(nvcc.BUILD_DIR, f"{name}-{zlib.crc32(text.encode()):08x}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


class MicroLog:
    """Every ``torch_allocate`` execute of a scheduler (the action object
    replaced by its own instance, so no other scheduler's cycle lands
    here): whether it was a micro-cycle, its rung, its split and the clock
    when it returned."""

    def __init__(self, sched) -> None:
        self.records: list[dict] = []
        sched.actions = [type(a)() for a in sched.actions]
        self.action = next(a for a in sched.actions if a.name == "torch_allocate")
        inner = self.action.execute

        def execute(ssn):
            inner(ssn)
            self.records.append({"micro": bool(ssn.micro_cycle), "tier": self.action.last_solver_tier,
                                 "end": time.perf_counter(), "timings": dict(self.action.last_timings),
                                 "jobs": set(ssn.jobs)})

        self.action.execute = execute
        inner_micro = sched.run_micro

        def run_micro(work):
            n = len(self.records)
            try:
                return inner_micro(work)
            finally:
                if len(self.records) > n:  # the scheduler's own split of the micro-cycle
                    self.records[-1]["micro_timings"] = dict(sched.last_micro_timings)

        sched.run_micro = run_micro

    def micro(self) -> list[dict]:
        return [r for r in self.records if r["micro"]]


def stream_seed(store, cut: int, churned: int = 0) -> None:
    """The resident world of ``streaming_100k``: nodes of 128 cpu / 256Gi /
    110 pods, resident gangs of Running 1 cpu / 2Gi pods spread round-robin."""
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.apis.types import PodPhase

    gangs, members, n_nodes = STREAM_WORLD[0] // cut, STREAM_WORLD[1], STREAM_WORLD[2] // cut
    store.create_queue(tt.build_queue("default"))
    for i in range(n_nodes):
        store.create_node(tt.build_node(f"n{i}", tt.build_resource_list(cpu=128, memory="256Gi", pods=110)))
    for g in range(gangs):
        store.create_pod_group(tt.build_pod_group(f"r{g}", min_member=members))
        for m in range(members):
            store.create_pod(tt.build_pod(
                name=f"r{g}-p{m}", group_name=f"r{g}", node_name=f"n{(g * members + m) % n_nodes}",
                phase=PodPhase.RUNNING, req=tt.build_resource_list(cpu=1, memory="2Gi")))


def stream_arrive(store, name: str, stamps: dict | None = None) -> None:
    from kube_batch_tpu_torch import testing as tt

    store.create_pod_group(tt.build_pod_group(name, min_member=ARRIVAL_MEMBERS))
    for m in range(ARRIVAL_MEMBERS):
        if stamps is not None:
            stamps[f"default/{name}-p{m}"] = time.perf_counter()
        store.create_pod(tt.build_pod(name=f"{name}-p{m}", group_name=name,
                                      req=tt.build_resource_list(cpu=1, memory="2Gi")))


def stream_churn(store, i: int) -> None:
    from kube_batch_tpu_torch import testing as tt

    store.update_node(tt.build_node(f"n{i}", tt.build_resource_list(cpu=128, memory="256Gi", pods=110),
                                    labels={"bench/churned": "1"}))


def micro_outcomes() -> dict:
    from kube_batch_tpu_torch import metrics

    return {dict(k)["outcome"]: v for k, v in metrics.micro_cycles.samples().items()}


def streaming_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``streaming_100k``: bench.py's ``sustained_arrival_row`` at its
    defaults through the port's streaming loop (module docstring, step 13).
    Returns the record and the main path's (B1, B2) launches."""
    import random

    import torch

    from kube_batch_tpu_torch import faults, metrics
    from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
    from kube_batch_tpu_torch.cache.store import PODS, EventHandler
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc
    from kube_batch_tpu_torch.scheduler import Scheduler

    on_card = device != "cpu"
    loop_device = "cuda:0" if on_card else None
    warm_n, probe_n, sustained_n = STREAM_ARRIVALS
    script = ([f"w{i}" for i in range(warm_n)] + [f"s{i}" for i in range(probe_n)]
              + [f"a{i}" for i in range(sustained_n)])
    rec: dict = {"phase": "streaming_100k", "device": device, "cut": cut,
                 "resident_pods": STREAM_WORLD[0] // cut * STREAM_WORLD[1], "nodes": STREAM_WORLD[2] // cut,
                 "arrival_pods": len(script) * ARRIVAL_MEMBERS, "offered_pods_per_s": STREAM_RATE}
    t0 = time.perf_counter()
    store = ClusterStore()
    stream_seed(store, cut)
    rec["ingest_s"] = time.perf_counter() - t0
    binds: dict[str, tuple[float, str]] = {}

    def on_update(old, new):
        if not old.node_name and new.node_name:
            binds[f"{new.namespace}/{new.name}"] = (time.perf_counter(), new.node_name)

    store.add_event_handler(PODS, EventHandler(on_update=on_update))
    t0 = time.perf_counter()
    cache = SchedulerCache(store)
    rec["cache_sync_s"] = time.perf_counter() - t0
    sched = Scheduler(cache, write_text(STREAM_CONF.format(device=device, streaming="true"), "stream"),
                      schedule_period=STREAM_PERIOD_S)
    log = MicroLog(sched)
    arrivals: dict[str, float] = {}

    def bound(name: str) -> bool:
        return all(f"default/{name}-p{m}" in binds for m in range(ARRIVAL_MEMBERS))

    def wait_gang(name: str, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while not bound(name):
            if time.monotonic() > deadline:
                raise AssertionError(f"gang {name} not bound within {timeout}s")
            time.sleep(0.0002)

    outcomes0 = micro_outcomes()
    ttb0 = metrics.time_to_bind.snapshot()["count"]
    breaker = faults.solver_ladder.breakers["fused"]
    if on_card:
        torch.cuda.synchronize()
    fs.fused_solve.launches = bs.block_step.launches = 0
    stop = threading.Event()
    thread = threading.Thread(target=sched.run, args=(stop, loop_device), name="kb-stream", daemon=True)
    t_start = time.perf_counter()
    thread.start()
    probe_lat: list[float] = []
    probe_split: list[dict] = []
    try:
        deadline = time.monotonic() + 300.0
        while sched._stream_state is None or not sched._stream_state.valid:  # the first full cycle
            if time.monotonic() > deadline or not thread.is_alive():
                raise AssertionError("the resident table was never adopted")
            time.sleep(0.01)
        rec["first_full_cycle"] = {"adopted_s": time.perf_counter() - t_start, **sched.last_timings}
        it = iter(script)
        for _ in range(warm_n):
            name = next(it)
            stream_arrive(store, name, arrivals)
            wait_gang(name)
        builds0 = nvcc.builds
        for _ in range(probe_n):
            name = next(it)
            n0 = len(log.records)
            t0 = time.perf_counter()
            stream_arrive(store, name, arrivals)
            wait_gang(name)
            probe_lat.append(time.perf_counter() - t0)
            # the micro-cycle that solved this gang (its record lands when
            # its execute returns, which may be after the binds)
            gang = f"default/{name}"
            wait_for(lambda: any(gang in r["jobs"] and "micro_timings" in r for r in log.records[n0:]),
                     f"the micro-cycle of {name}")
            mine = [r for r in log.records[n0:] if gang in r["jobs"] and r["timings"].get("encode_s") is not None]
            if mine:
                last_bind = max(binds[f"default/{name}-p{m}"][0] for m in range(ARRIVAL_MEMBERS))
                probe_split.append({**mine[-1]["timings"], **{f"sched_{k}": v for k, v in
                                                              mine[-1]["micro_timings"].items()},
                                    "write_back_s": last_bind - mine[-1]["end"], "bind_s": probe_lat[-1]})
        rng = random.Random(7)
        sustained_start = time.perf_counter()
        for g in range(sustained_n):
            stream_arrive(store, next(it), arrivals)
            if g % 10 == 9:
                stream_churn(store, g)  # the resident node-patch path
            time.sleep(rng.expovariate(STREAM_RATE / ARRIVAL_MEMBERS))
        for g in range(sustained_n):
            wait_gang(f"a{g}")
        rec["builds_after_warm_up"] = nvcc.builds - builds0
    finally:
        stop.set()
        thread.join(timeout=60.0)
        cache.stop()
    micro_cycles = sched.micro_cycles_run
    if on_card:
        torch.cuda.synchronize()
    launches = (fs.fused_solve.launches, bs.block_step.launches)
    if thread.is_alive():
        raise AssertionError("the streaming loop did not stop")
    keys = [f"default/a{g}-p{m}" for g in range(sustained_n) for m in range(ARRIVAL_MEMBERS)]
    lat = sorted(binds[k][0] - arrivals[k] for k in keys)
    span = max(binds[k][0] for k in keys) - sustained_start
    outcomes = {k: v - outcomes0.get(k, 0.0) for k, v in micro_outcomes().items() if v - outcomes0.get(k, 0.0)}
    micro = log.micro()
    solved = [r for r in micro if r["tier"] != "none"]
    rec.update({
        "micro_cycles": micro_cycles, "micro_cycles_by_outcome": outcomes,
        "micro_solves": len(solved), "micro_tiers": sorted({r["tier"] for r in micro}),
        "full_cycles": sum(1 for r in log.records if not r["micro"]),
        "probe_bind_s": probe_lat, "probe_p50_bind_ms": nearest_rank(probe_lat, 50) * 1e3,
        "sustained_pods_per_s": len(keys) / span,
        "time_to_bind_p50_ms": nearest_rank(lat, 50) * 1e3, "time_to_bind_p90_ms": nearest_rank(lat, 90) * 1e3,
        "time_to_bind_p99_ms": nearest_rank(lat, 99) * 1e3,
        "time_to_bind_observed": metrics.time_to_bind.snapshot()["count"] - ttb0,
        "b1_launches": launches[0], "b2_launches": launches[1],
        "micro_split_median_s": {k: statistics.median(p[k] for p in probe_split)
                                 for k in probe_split[0] if isinstance(probe_split[0][k], float)
                                 and all(k in p for p in probe_split)} if probe_split else {},
        "micro_split_probes": probe_split,
        "breaker_fused": breaker.state,
        # the tensor arena's counters summed over micro-cycles and full
        # cycles apart: a micro-cycle's task axis differs from a full
        # cycle's, so its statics mostly go up whole
        "arena_by_cycle_kind": {
            kind: {k: sum(r["timings"].get(f"arena_{k}", 0) for r in log.records if r["micro"] == (kind == "micro"))
                   for k in ("reuses", "row_updates", "full_uploads", "rows_uploaded", "failures")}
            for kind in ("micro", "full")
        },
    })
    stream_placed = {k: v[1] for k, v in binds.items()}

    # the full-cycle twin: the same resident world, every arrival and churn,
    # placed by ONE full cycle
    twin = ClusterStore()
    stream_seed(twin, cut)
    for name in script:
        stream_arrive(twin, name)
    for g in range(sustained_n):
        if g % 10 == 9:
            stream_churn(twin, g)
    twin_cache = SchedulerCache(twin)
    twin_sched = Scheduler(twin_cache, write_text(STREAM_CONF.format(device=device, streaming="false"), "stream"))
    if on_card:
        torch.cuda.set_device(0)
    t0 = time.perf_counter()
    twin_sched.run_once()
    rec["twin_run_once_s"] = time.perf_counter() - t0
    twin_placed = {f"{p.namespace}/{p.name}": p.node_name for p in twin.list(PODS)
                   if not p.name.startswith("r") and p.node_name}
    rec["placements_equal_full_cycle"] = stream_placed == twin_placed
    emit_failures = []
    if stream_placed != twin_placed:
        diff = sorted(set(stream_placed.items()) ^ set(twin_placed.items()))
        emit_failures.append(f"placements differ from the full-cycle twin on {len(diff)} entries, first {diff[:4]}")
    if len(stream_placed) != len(script) * ARRIVAL_MEMBERS:
        emit_failures.append(f"{len(stream_placed)} of {len(script) * ARRIVAL_MEMBERS} arrivals bound")
    bad = {k: v for k, v in outcomes.items() if k not in ("ok", "empty")}
    if bad:
        emit_failures.append(f"micro-cycles degraded: {bad}")
    if not solved or any(r["tier"] != "fused" for r in solved):
        emit_failures.append(f"micro-cycles off the fused rung: {rec['micro_tiers']}")
    if rec["builds_after_warm_up"]:
        emit_failures.append(f"{rec['builds_after_warm_up']} kernel builds after warm-up")
    if on_card and launches[0] < len(solved):
        emit_failures.append(f"{launches[0]} B1 launches for {len(solved)} micro solves")
    if breaker.state != "closed":
        emit_failures.append(f"the fused breaker is {breaker.state}")
    if emit_failures:
        emit(rec)
        raise AssertionError("; ".join(emit_failures))
    return rec, launches


def session_cluster(base):
    """A cluster sharing ``base``'s nodes and queues, with job clones that
    own their PodGroups: a session's close writes its statuses there, and
    ``base`` stays the world every session starts from."""
    import copy
    import dataclasses

    from kube_batch_tpu_torch.api.cluster_info import ClusterInfo

    jobs = {}
    for uid, job in base.jobs.items():
        c = job.clone()
        if c.pod_group is not None:
            c.pod_group = dataclasses.replace(c.pod_group, status=copy.deepcopy(c.pod_group.status))
        jobs[uid] = c
    return ClusterInfo(jobs=jobs, nodes=base.nodes, queues=base.queues)


def pipelined_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``pipelined_50k_5k``: ``preempt_mix(50_000, 5_000)`` through
    ``Scheduler.run_once`` (``torch_allocate`` alone) on the fused rung,
    one warm and PIPE_SESSIONS measured sessions back to back without the
    pipeline, then as many with ``KBT_PIPELINE=1``, each session a fresh
    FakeCache over the same world (all built before the column); then the
    ``cycle.overrun`` drill under the pipeline. Returns the record and the
    sessions' (B1, B2) launches. ``column_s`` is the measured sessions'
    wall clock with their dispatches landed; the overlap fraction is the
    fence's own reading (a pipelined ``run_once`` closes its session behind
    the dispatch, and that join is the first)."""
    import torch

    from kube_batch_tpu_torch import faults, metrics, models, pipeline
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    import gc

    on_card = device != "cpu"
    # torch_allocate alone, as bench.py's row runs it: a later action
    # (backfill) would join the deferred dispatch before it runs
    conf = conf_file(actions="torch_allocate", **({} if on_card else {"device": "cpu"}))
    t0 = time.perf_counter()
    base = models.preempt_mix(50_000 // cut, 5_000 // cut)
    rec: dict = {"phase": "pipelined_50k_5k", "device": device, "cut": cut, "generate_s": time.perf_counter() - t0}
    saved = os.environ.get(pipeline.ENV)
    if on_card:
        torch.cuda.synchronize()
    fs.fused_solve.launches = bs.block_step.launches = 0
    before = degradations()
    columns: dict = {}
    try:
        for column, env in (("sync", "0"), ("pipelined", "1")):
            os.environ[pipeline.ENV] = env
            pipeline.reset()
            wait0 = metrics.pipeline_fence_wait_seconds.snapshot()
            runs, caches, tails = [], [], []
            # every session's world built first, and the garbage collected,
            # so the sessions run back to back as a loop's cycles would,
            # with nothing of the harness inside a dispatch's window
            clusters = [session_cluster(base) for _ in range(1 + PIPE_SESSIONS)]
            gc.collect()
            t_column = 0.0
            for i, cluster in enumerate(clusters):
                cache = FakeCache(cluster)
                sched = Scheduler(cache, conf)
                alloc = next(a for a in sched.actions if a.name == "torch_allocate")
                t0 = time.perf_counter()
                if i == 1:
                    t_column = t0
                sched.run_once()
                run_once_s = time.perf_counter() - t0
                if alloc.last_solver_tier != "fused" or "aborted" in sched.last_timings:
                    raise AssertionError(f"{column} session {i}: rung {alloc.last_solver_tier}, "
                                         f"{sched.last_timings.get('aborted', 'not aborted')}")
                tails.append(alloc.last_timings)  # the deferred closure writes replay_s here
                caches.append(cache)
                if i:
                    runs.append({"run_once_s": run_once_s, "cycle": dict(sched.last_timings)})
            del clusters
            if not pipeline.fence.wait():
                raise AssertionError(f"{column}: the last dispatch did not land: {pipeline.fence.degraded_reason}")
            column_s = time.perf_counter() - t_column  # the measured sessions, their dispatches landed
            wait1 = metrics.pipeline_fence_wait_seconds.snapshot()
            for r, t in zip(runs, tails[1:]):
                r["torch_allocate"] = dict(t)
            columns[column] = {
                "runs": runs, "run_once_s": [r["run_once_s"] for r in runs],
                "p50_run_once_s": statistics.median(r["run_once_s"] for r in runs), "column_s": column_s,
                "deferred_dispatch_s": [t.get("replay_s") for t in tails[1:]] if column == "pipelined" else [],
                "replay_s": [t.get("replay_s") for t in tails[1:]],
                "fence_waits": wait1["count"] - wait0["count"], "fence_wait_s": wait1["sum"] - wait0["sum"],
                "overlap_fraction": pipeline.fence.last_overlap_fraction,
                "dispatch_s_last": pipeline.fence._dispatch_s,
                "binds": [dict(c.binder.binds) for c in caches],
                "degraded": pipeline.fence.degraded_reason,
            }
        if on_card:
            torch.cuda.synchronize()
        launches = (fs.fused_solve.launches, bs.block_step.launches)
        grew = {k: v - before[k] for k, v in degradations().items() if v != before[k]}
        sync, pipe = columns["sync"], columns["pipelined"]
        want = sync["binds"][0]
        failures = []
        if any(b != want for b in sync["binds"] + pipe["binds"]) or not want:
            failures.append("binds differ from the synchronous column's first session")
        if not pipe["dispatch_s_last"] > 0 or not all(s and s > 0 for s in pipe["deferred_dispatch_s"]):
            failures.append("no dispatch was deferred")
        if pipe["degraded"] or grew:
            failures.append(f"degraded: {pipe['degraded']} {grew}")

        # the overrun drill under the pipeline: the barrier runs before the
        # submission, so the aborted cycle binds nothing and defers nothing
        os.environ[pipeline.ENV] = "1"
        pipeline.reset()
        cache = FakeCache(session_cluster(base))
        sched = Scheduler(cache, conf)
        faults.registry.arm("cycle.overrun", count=1)
        try:
            t0 = time.perf_counter()
            sched.run_once()
            aborted_s = time.perf_counter() - t0
        finally:
            faults.registry.reset()
        overrun = {"aborted": sched.last_timings.get("aborted"), "aborted_s": aborted_s,
                   "binds": len(cache.binder.binds), "pending": pipeline.fence.pending()}
        if not overrun["aborted"] or overrun["binds"] or overrun["pending"]:
            failures.append(f"the overrun drill did not discard cleanly: {overrun}")
        t0 = time.perf_counter()
        sched.run_once()
        pipeline.fence.wait()
        overrun["next_s"] = time.perf_counter() - t0
        overrun["next_binds_equal"] = dict(cache.binder.binds) == want
        if not overrun["next_binds_equal"] or pipeline.fence.degraded_reason:
            failures.append("the cycle after the overrun did not bind as the synchronous column")
    finally:
        if saved is None:
            os.environ.pop(pipeline.ENV, None)
        else:
            os.environ[pipeline.ENV] = saved
        pipeline.reset()
    for col in columns.values():
        col["binds"] = len(col["binds"][0])
    rec.update({"sessions": PIPE_SESSIONS, "columns": columns, "overrun": overrun,
                "b1_launches": launches[0], "b2_launches": launches[1],
                "p50_speedup_vs_sync_pct": 100.0 * (1.0 - columns["pipelined"]["p50_run_once_s"]
                                                     / columns["sync"]["p50_run_once_s"])})
    if failures:
        emit(rec)
        raise AssertionError("; ".join(failures))
    return rec, launches


def drill_store(nodes: int = STREAM_DRILL_NODES):
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.cache import ClusterStore

    store = ClusterStore()
    store.create_queue(tt.build_queue("default"))
    for i in range(nodes):
        store.create_node(tt.build_node(f"n{i}", tt.build_resource_list(cpu=16, memory="16Gi", pods=64)))
    return store


def drill_gang(store, name: str, members: int) -> None:
    from kube_batch_tpu_torch import testing as tt

    store.create_pod_group(tt.build_pod_group(name, min_member=members))
    for m in range(members):
        store.create_pod(tt.build_pod(name=f"{name}-p{m}", group_name=name,
                                      req=tt.build_resource_list(cpu=1, memory="512Mi")))


def wait_for(pred, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def all_bound(store) -> bool:
    pods = store.list("pods")
    return bool(pods) and all(p.node_name for p in pods)


def bind_counter(store) -> dict:
    from kube_batch_tpu_torch.cache.store import PODS, EventHandler

    counts: dict[str, int] = {}

    def on_update(old, new):
        if not old.node_name and new.node_name:
            counts[f"{new.namespace}/{new.name}"] = counts.get(f"{new.namespace}/{new.name}", 0) + 1

    store.add_event_handler(PODS, EventHandler(on_update=on_update))
    return counts


def stream_drill(kind: str, device: str, tmp: str) -> dict:
    """One drill of ``streaming_drills`` on ``device``; returns its
    outcome, compared between the card and the CPU."""
    import zlib

    from kube_batch_tpu_torch import faults, federation, pipeline, streaming
    from kube_batch_tpu_torch.cache import SchedulerCache
    from kube_batch_tpu_torch.recovery import WriteIntentJournal, reconcile_journal
    from kube_batch_tpu_torch.scheduler import Scheduler

    loop_device = "cuda:0" if device != "cpu" else None
    conf = {s: write_text(streaming.smoke_conf(s, device), "stream-drill") for s in (True, False)}
    if kind == "a_smoke":
        r = streaming.smoke(device=device)
        if not r["ok"]:
            raise AssertionError(f"streaming.smoke failed: {r}")
        return {k: r[k] for k in ("ok", "bound", "pods", "parity", "full_cycle_micro_cycles")} | {
            "micro_cycles_taken": r["micro_cycles"] > 0}
    if kind == "b_federation":
        r = federation.smoke_streaming(device=device)
        if not r["ok"]:
            raise AssertionError(f"federation.smoke_streaming failed: {r}")
        return {k: r[k] for k in ("ok", "bound", "pods", "parity", "exactly_once", "listeners_clean",
                                  "pumps_joined")} | {"micro_cycles_taken": r["micro_cycles"] > 0}
    if kind == "c_micro_fault":
        faults.registry.arm("stream.micro_cycle", count=1)
        store = drill_store()
        cache = SchedulerCache(store)
        sched = Scheduler(cache, conf[True], schedule_period=30.0)
        stop = threading.Event()
        t = threading.Thread(target=sched.run, args=(stop, loop_device), daemon=True)
        t.start()
        try:
            wait_for(lambda: sched._stream_state is not None and sched._stream_state.valid, "the resident table")
            drill_gang(store, "g0", 4)
            wait_for(lambda: all_bound(store), "g0 bound despite the micro fault")
            before = sched.micro_cycles_run
            drill_gang(store, "g1", 4)
            wait_for(lambda: all_bound(store), "g1 bound")
            wait_for(lambda: sched.micro_cycles_run > before, "the micro path resumed")
        finally:
            stop.set()
            t.join(timeout=30.0)
            cache.stop()
            fired = faults.registry.active()["stream.micro_cycle"][2]
            faults.registry.reset()
        if fired != 1:
            raise AssertionError(f"stream.micro_cycle fired {fired} times")
        return {"fired": fired, "final": placements(store)}
    if kind == "d_fence":
        saved = os.environ.get(pipeline.ENV)
        os.environ[pipeline.ENV] = "1"
        pipeline.reset()
        try:
            store = drill_store(4)
            counts = bind_counter(store)
            sched = Scheduler(SchedulerCache(store), conf[False])
            if loop_device is not None:
                import torch

                torch.cuda.set_device(0)
            drill_gang(store, "g0", 3)
            sched.run_once()
            if not pipeline.fence._dispatch_s > 0:
                raise AssertionError("the first cycle deferred no dispatch")
            faults.registry.arm("pipeline.fence", count=1)
            drill_gang(store, "g1", 3)
            sched.run_once()  # the fence wait fires: the cycle is skipped
            out = {"skipped": sched.last_timings.get("skipped"), "degraded": bool(pipeline.fence.degraded_reason),
                   "enabled_after": pipeline.enabled()}
            faults.registry.reset()
            sched.run_once()
            drill_gang(store, "g2", 3)
            sched.run_once()
            out.update(all_bound=all_bound(store), binds=len(counts), once=all(n == 1 for n in counts.values()),
                       final=placements(store))
        finally:
            faults.registry.reset()
            pipeline.reset()
            if saved is None:
                os.environ.pop(pipeline.ENV, None)
            else:
                os.environ[pipeline.ENV] = saved
        if not (out["degraded"] and not out["enabled_after"] and out["all_bound"] and out["once"]
                and out["binds"] == 9):
            raise AssertionError(f"the fence drill: {out}")
        return out
    if kind == "e_killed_deferred":
        twin = drill_store(4)
        for g in range(2):
            drill_gang(twin, f"g{g}", 6)
        Scheduler(SchedulerCache(twin), conf[False]).run_once()
        expected = placements(twin)
        saved = os.environ.get(pipeline.ENV)
        os.environ[pipeline.ENV] = "1"
        pipeline.reset()
        wal = os.path.join(tmp, f"stream-{device}.wal")
        try:
            store = drill_store(4)
            counts = bind_counter(store)
            journal = WriteIntentJournal(wal)
            sched = Scheduler(SchedulerCache(store, journal=journal, binder=DyingBinder(store, 4)), conf[False])
            for g in range(2):
                drill_gang(store, f"g{g}", 6)
            try:
                sched.run_once()
                raise AssertionError("the leader survived its binder")
            except LeaderKilled:
                pass
            landed = sum(1 for v in placements(store).values() if v)
            orphans = len(WriteIntentJournal.replay(wal).orphans)
            journal.close()
            with open(wal, "rb") as f:
                wal_bytes = f.read()
        finally:
            pipeline.reset()
            if saved is None:
                os.environ.pop(pipeline.ENV, None)
            else:
                os.environ[pipeline.ENV] = saved
        standby = WriteIntentJournal(wal)
        report = reconcile_journal(standby, store)
        Scheduler(SchedulerCache(store), conf[False]).run_once()
        standby.close()
        out = {"landed": landed, "orphans": orphans, "redispatched": report.redispatched,
               "rolled_back": report.rolled_back, "final": placements(store),
               "once": all(n == 1 for n in counts.values()), "journal_crc": f"{zlib.crc32(wal_bytes):08x}"}
        if not (0 < landed < 12 and orphans and report.redispatched == orphans and not report.rolled_back
                and out["final"] == expected and out["once"] and set(counts) == set(expected)):
            raise AssertionError(f"the killed-leader drill: {out}")
        return out
    raise ValueError(kind)


STREAM_DRILLS = ("a_smoke", "b_federation", "c_micro_fault", "d_fence", "e_killed_deferred")


def streaming_drills(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``streaming_drills``: each drill on ``device`` and again on the CPU,
    ending equal (module docstring, step 13). Returns the record and the
    card runs' B1 launches."""
    import tempfile

    import torch

    from kube_batch_tpu_torch.ops import fused_solve as fs

    rec: dict = {"phase": "streaming_drills", "device": device, "drills": {}}
    launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        for kind in STREAM_DRILLS:
            out = {}
            for dev in dict.fromkeys((device, "cpu")):
                if dev != "cpu":
                    torch.cuda.synchronize()
                b1 = fs.fused_solve.launches
                t0 = time.perf_counter()
                out[dev] = stream_drill(kind, dev, tmp)
                out[dev]["s"] = time.perf_counter() - t0
                if dev != "cpu":
                    torch.cuda.synchronize()
                    out[dev]["b1_launches"] = fs.fused_solve.launches - b1
                    launches += out[dev]["b1_launches"]
                    if not out[dev]["b1_launches"]:
                        raise AssertionError(f"{kind} on {dev} launched no B1")
            strip = lambda o: {k: v for k, v in o.items() if k not in ("s", "b1_launches")}  # noqa: E731
            if strip(out[device]) != strip(out["cpu"]):
                raise AssertionError(f"{kind}: the card's run ends otherwise than the CPU's: "
                                     f"{strip(out[device])} != {strip(out['cpu'])}")
            rec["drills"][kind] = {dev: {k: v for k, v in o.items() if k != "final"} for dev, o in out.items()}
    rec["b1_launches"] = launches
    return rec, (launches, 0)


def streaming_phases(device: str = "cuda", cut: int = 1) -> tuple[list[str], dict]:
    """The streaming scheduler's phases: ``streaming_100k``,
    ``pipelined_50k_5k`` (whose overrun drill checks its own
    degradations) and ``streaming_drills``. Returns the failures and the
    launches of each phase's main path."""
    failures, launches = [], {}

    def streamed():
        rec, launches["streaming_100k"] = streaming_phase(device, cut)
        emit(rec)

    def pipelined():
        rec, launches["pipelined_50k_5k"] = pipelined_phase(device, cut)
        emit(rec)

    def drills():
        rec, launches["streaming_drills"] = streaming_drills(device)
        emit(rec)

    t0 = time.perf_counter()
    run_phase(failures, "streaming_100k", streamed)
    run_phase(failures, "pipelined_50k_5k", pipelined, drill=True)
    run_phase(failures, "streaming_drills", drills, drill=True)
    emit({"phase": "streaming_phases_total", "s": time.perf_counter() - t0})
    return failures, launches


# -- the operator surfaces: explain, the fleet rollup, admission -------------

EXPLAIN_WORLD = (50_000, 1_000)  # preempt_mix: capacity short, hundreds of gangs stay pending
EXPLAIN_PASS_RUNS = 5  # timed runs of the batched pass on the card (CUDA events)
STORM_SHARDS = 2
STORM_S = 8.0  # admission.storm_row's duration per storm
EXPLAIN_DRILLS = ("a_smoke", "b_micro_cycle", "c_journal", "d_debug_endpoint")


class ExplainSpy:
    """Captures each ``obs.explain.forensics`` call (the encoded snapshot,
    the arrays, the final SolveState, the pass's device inputs and its
    fetched result) and every ``publish`` with its session's kind, while
    armed; restores both on exit."""

    def __init__(self) -> None:
        self.calls: list[dict] = []
        self.published: list[tuple[bool, list[str]]] = []

    def __enter__(self) -> "ExplainSpy":
        from kube_batch_tpu_torch.obs import explain

        self._real = (explain.forensics, explain.publish)
        forensics, publish = self._real

        def spy(enc, arrays, state, inputs=None, topk=explain.TOP_K):
            fx = forensics(enc, arrays, state, inputs, topk)
            self.calls.append({"enc": enc, "arrays": arrays, "state": state, "inputs": inputs, "fx": fx})
            return fx

        def pub(ssn, recs):
            self.published.append((bool(getattr(ssn, "micro_cycle", False)), sorted(recs)))
            return publish(ssn, recs)

        explain.forensics, explain.publish = spy, pub
        return self

    def __exit__(self, *exc) -> None:
        from kube_batch_tpu_torch.obs import explain

        explain.forensics, explain.publish = self._real


class Explaining:
    """``KBT_EXPLAIN=1`` (or unset) for a block, the registry cleared; the
    switch restored on exit."""

    def __init__(self, on: bool = True) -> None:
        self.on = on

    def __enter__(self) -> None:
        from kube_batch_tpu_torch.obs import explain

        self._saved = os.environ.get(explain.ENV)
        if self.on:
            os.environ[explain.ENV] = "1"
        else:
            os.environ.pop(explain.ENV, None)
        explain.configure()
        explain.records.clear()

    def __exit__(self, *exc) -> None:
        from kube_batch_tpu_torch.obs import explain

        if self._saved is None:
            os.environ.pop(explain.ENV, None)
        else:
            os.environ[explain.ENV] = self._saved
        explain.configure()


def canon(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def explain_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``explain_50k_1k`` (module docstring, step 14)."""
    import types

    import numpy as np
    import torch

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.obs import explain
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import explain as ops_explain
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    on_card = device != "cpu"
    pods, nodes = EXPLAIN_WORLD[0] // cut, EXPLAIN_WORLD[1] // cut
    t0 = time.perf_counter()
    cluster = models.preempt_mix(pods, nodes)
    generate_s = time.perf_counter() - t0
    conf = conf_file(actions="enqueue, torch_allocate", device=device)

    def cycle(on: bool) -> tuple[dict, dict, ExplainSpy]:
        with Explaining(on), ExplainSpy() as spy:
            cache = FakeCache(cluster)
            sched = Scheduler(cache, conf)
            if on_card:
                torch.cuda.synchronize()
            fs.fused_solve.launches = bs.block_step.launches = 0
            t0 = time.perf_counter()
            sched.run_once()
            if on_card:
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            b1, b2 = fs.fused_solve.launches, bs.block_step.launches
            act = next(a for a in sched.actions if a.name == "torch_allocate")
            if act.last_solver_tier != "fused" or "aborted" in sched.last_timings:
                raise AssertionError(f"explain {'on' if on else 'off'}: the {act.last_solver_tier!r} rung, "
                                     f"{sched.last_timings.get('aborted')}")
            if on_card and (b1 < 1 or b2):
                raise AssertionError(f"explain {'on' if on else 'off'}: {b1} B1 and {b2} B2 launches")
            rec = {"run_once_s": wall_s, "cycle": dict(sched.last_timings),
                   "torch_allocate": dict(act.last_timings), "b1_launches": b1, "b2_launches": b2,
                   "records": {r["gang"]: r for r in explain.records.snapshot()}}
        return rec, dict(cache.binder.binds), spy

    off, off_binds, off_spy = cycle(False)
    # the process's first explain cycle pays the first launch of each of
    # the pass's torch kernels; the second is the steady state
    cold, cold_binds, _ = cycle(True)
    on, on_binds, spy = cycle(True)
    if off_spy.calls or off["records"] or "explain_s" in off["torch_allocate"]:
        raise AssertionError("explain off: the cycle ran the forensics")
    if not on_binds == cold_binds == off_binds:
        raise AssertionError(f"explain on binds {len(on_binds)} pods, off {len(off_binds)}: the binds differ")
    if canon(cold["records"]) != canon(on["records"]):
        raise AssertionError("the two explain cycles published different records")
    if len(spy.calls) != 1:
        raise AssertionError(f"{len(spy.calls)} forensics passes in the explain cycle")
    call = spy.calls[0]
    enc, arrays, state, inputs = call["enc"], call["arrays"], call["state"], call["inputs"]
    # the records the cycle published against explain_rows_np's over the
    # same final state (the numpy twin, task by task)
    job_rows = call["fx"].job_rows
    G = len(job_rows)
    if G < 1:
        raise AssertionError("no gang stayed pending: the phase explains nothing")
    rows = [r for _, r in job_rows]
    t0 = time.perf_counter()
    twin = ops_explain.explain_rows_np(
        arrays, state.idle.numpy(), state.rel.numpy(), state.used.numpy(), state.ntasks.numpy(),
        state.nports.numpy(), rows,
    )
    twin_s = time.perf_counter() - t0
    want = explain.post_solve_records(types.SimpleNamespace(jobs={}, queues={}), enc, arrays,
                                      state.ready_cnt.numpy(), explain.Forensics(job_rows, twin))
    got = {uid: on["records"].get(uid) for uid in want}
    if canon(got) != canon(want):
        bad = [uid for uid in want if canon(got[uid]) != canon(want[uid])]
        raise AssertionError(f"{len(bad)} of {G} records differ from explain_rows_np's, first {bad[0]}: "
                             f"{got[bad[0]]} != {want[bad[0]]}")
    # the pass on the solve's device (the cycle's own, fetched, and timed
    # re-runs) against the same call on the CPU
    rep_rows = ops_explain.pad_rows(rows)
    a_dev, st_dev = inputs
    a_cpu, st_cpu = ops_explain.uploaded_inputs(arrays, state, "cpu")
    t0 = time.perf_counter()
    cpu_out = ops_explain.explain_batch(a_cpu, *st_cpu, rep_rows)
    cpu_s = time.perf_counter() - t0
    for name, d, c in zip(("elim", "feasible", "would_fit", "nm_idx", "nm_score", "nm_planes"), call["fx"].out,
                          cpu_out):
        if not np.array_equal(d, c.numpy()) or d.dtype != c.numpy().dtype:
            raise AssertionError(f"the cycle's explain pass: {name} differs from the CPU run")
    device_ms = []
    for _ in range(EXPLAIN_PASS_RUNS if on_card else 1):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dev_out = ops_explain.explain_batch(a_dev, *st_dev, rep_rows)
            end.record()
            torch.cuda.synchronize()
            device_ms.append(start.elapsed_time(end))
        else:
            dev_out = ops_explain.explain_batch(a_dev, *st_dev, rep_rows)
    if on_card and any(x.device.type != "cuda" for x in dev_out):
        raise AssertionError("the explain pass left the card")
    for name, d, c in zip(("elim", "feasible", "would_fit", "nm_idx", "nm_score", "nm_planes"), dev_out, cpu_out):
        if d.dtype != c.dtype or not torch.equal(d.cpu(), c):
            raise AssertionError(f"explain_batch's {name} on {device} differs from its CPU run")
    reasons: dict = {}
    for r in want.values():
        reasons[r["reason"]] = reasons.get(r["reason"], 0) + 1
    explain_s = on["torch_allocate"]["explain_s"]
    rec = {
        "phase": "explain_50k_1k", "device": device, "pods": pods, "nodes": nodes, "generate_s": generate_s,
        "G": G, "padded_rows": len(rep_rows), "n_node_rows": int(arrays["node_valid"].shape[0]),
        "explain_s": explain_s, "explain_pass_s": on["torch_allocate"]["explain_pass_s"],
        "explain_share_of_cycle": explain_s / on["run_once_s"],
        "first_cycle": {"explain_s": cold["torch_allocate"]["explain_s"],
                        "explain_pass_s": cold["torch_allocate"]["explain_pass_s"], "run_once_s": cold["run_once_s"]},
        "device_ms": device_ms, "device_ms_median": statistics.median(device_ms) if device_ms else None,
        "cpu_pass_s": cpu_s, "explain_rows_np_s": twin_s,
        "run_once_s": {"on": on["run_once_s"], "off": off["run_once_s"]},
        "torch_allocate": {"on": on["torch_allocate"], "off": off["torch_allocate"]},
        "binds": len(on_binds), "binds_equal": True, "records_equal_twin": True, "card_equals_cpu": True,
        "reasons": reasons, "b1_launches": on["b1_launches"] + cold["b1_launches"] + off["b1_launches"],
        "b1_launches_by_cycle": {"off": off["b1_launches"], "first_on": cold["b1_launches"], "on": on["b1_launches"]},
    }
    if cut > 1:
        rec["reduced"] = {"pods": [EXPLAIN_WORLD[0], pods], "nodes": [EXPLAIN_WORLD[1], nodes]}
    return rec, (rec["b1_launches"], 0)


def explain_seed(store, stuck: bool = True) -> None:
    """tests/test_explain.py's store: 4 nodes of 16 cpu, a 3-pod gang that
    fits (``g-fit``) and a 1-pod gang of 999 cpu (``g-stuck``)."""
    from kube_batch_tpu_torch import testing as tt

    store.create_queue(tt.build_queue("default"))
    for i in range(4):
        store.create_node(tt.build_node(f"n{i}", tt.build_resource_list(cpu=16, memory="16Gi", pods=32)))
    store.create_pod_group(tt.build_pod_group("g-fit", min_member=3))
    for m in range(3):
        store.create_pod(tt.build_pod(name=f"g-fit-p{m}", group_name="g-fit",
                                      req=tt.build_resource_list(cpu=1, memory="512Mi")))
    if stuck:
        store.create_pod_group(tt.build_pod_group("g-stuck", min_member=1))
        store.create_pod(tt.build_pod(name="g-stuck-p0", group_name="g-stuck",
                                      req=tt.build_resource_list(cpu=999, memory="512Mi")))


def explain_drill(kind: str, device: str) -> dict:
    """One drill of ``explain_drills`` on ``device``; returns its outcome,
    compared between the card and the CPU."""
    import io
    import urllib.request

    from kube_batch_tpu_torch import cli, streaming
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
    from kube_batch_tpu_torch.cache.store import PODS
    from kube_batch_tpu_torch.obs import explain
    from kube_batch_tpu_torch.recovery import WriteIntentJournal
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.server import SchedulerServer

    conf = write_text(streaming.smoke_conf(False, device), "explain-drill")
    if kind == "a_smoke":
        # the smoke world through serial allocate, the fused rung and the
        # sharded rung (a mesh of two shards on the device), all equal
        r = explain.smoke(device=device)
        if not r["ok"]:
            raise AssertionError(f"obs.explain.smoke failed: {r}")
        return {k: r[k] for k in ("ok", "gangs", "tiers", "parity", "reasons", "aggregate")}
    if kind == "b_micro_cycle":
        # a streaming micro-cycle's session holds only its dirty gangs
        store = ClusterStore()
        explain_seed(store)
        cache = SchedulerCache(store)
        sched = Scheduler(cache, write_text(streaming.smoke_conf(True, device), "explain-drill-stream"),
                          schedule_period=30.0)
        stop = threading.Event()
        with Explaining(), ExplainSpy() as spy:
            t = threading.Thread(target=sched.run, args=(stop, "cuda:0" if device != "cpu" else None), daemon=True)
            t.start()
            try:
                wait_for(lambda: explain.records.get("default/g-stuck") is not None, "g-stuck's full-cycle record")
                before = sched.micro_cycles_run
                store.create_pod_group(tt.build_pod_group("g-new", min_member=2))
                for m in range(2):
                    store.create_pod(tt.build_pod(name=f"g-new-p{m}", group_name="g-new",
                                                  req=tt.build_resource_list(cpu=1, memory="512Mi")))
                wait_for(lambda: sum(1 for p in store.list(PODS) if p.node_name) >= 5, "g-new's binds")
                wait_for(lambda: (explain.records.get("default/g-new") or {}).get("verdict") == "bound",
                         "g-new's bound record")
            finally:
                stop.set()
                t.join(timeout=30)
                cache.stop()
            micro = [gangs for is_micro, gangs in spy.published if is_micro]
            out = {
                "micro_cycles": sched.micro_cycles_run > before,
                "micro_publishes_dirty_only": bool(micro) and all(g == ["default/g-new"] for g in micro),
                "full_cycle_gangs": next(g for is_micro, g in spy.published if not is_micro),
                "g_new": explain.records.get("default/g-new")["verdict"],
                "g_stuck": explain.records.get("default/g-stuck")["reason"],
            }
        if not (out["micro_cycles"] and out["micro_publishes_dirty_only"]):
            raise AssertionError(f"micro-cycle explain: {out}, publishes {spy.published}")
        return out
    if kind == "c_journal":
        # the cycle's journal intents carry the gangs' explain payloads
        import tempfile

        store = ClusterStore()
        explain_seed(store)
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp, Explaining():
            wal = os.path.join(tmp, "j.wal")
            cache = SchedulerCache(store, journal=WriteIntentJournal(wal))
            Scheduler(cache, conf).run_once()
            with open(wal) as f:
                intents = [r for r in map(json.loads, f.read().splitlines()) if r.get("rec") == "intent"]
            stuck = explain.records.get("default/g-stuck")
        out = {"intents": len(intents), "tagged": sum("explain" in r for r in intents),
               "payloads": sorted({canon(r["explain"]) for r in intents if "explain" in r}),
               "g_stuck": stuck and stuck["reason"]}
        if not out["intents"] or out["tagged"] != out["intents"] or out["g_stuck"] != "resources":
            raise AssertionError(f"journal explain: {out}")
        return out
    # d_debug_endpoint: /debug/explain, the reason counters and the CLI over
    # a server whose own loop scheduled the store
    with Explaining():
        srv = SchedulerServer(listen_address="127.0.0.1:0", schedule_period=0.05, scheduler_conf=conf)
        explain_seed(srv.store)
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.listen_port}"
            wait_for(lambda: sum(1 for p in srv.store.list(PODS) if p.node_name) >= 3
                     and explain.records.get("default/g-stuck") is not None, "the server's explain records")
            with urllib.request.urlopen(base + "/debug/explain", timeout=10) as r:
                payload = json.loads(r.read())
            with urllib.request.urlopen(base + "/debug/explain?gang=default/g-stuck", timeout=10) as r:
                one = json.loads(r.read())
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                text = r.read().decode()
            buf = io.StringIO()
            code = cli.main(["--server", base, "explain"], out=buf)
        finally:
            srv.stop()
    out = {
        "enabled": payload["enabled"], "gangs": sorted(r["name"] for r in payload["records"]),
        "aggregate": payload["aggregate"], "one": [r["reason"] for r in one["records"]],
        "unschedulable_counter": 'kube_batch_tpu_unschedulable_total{reason="resources"}' in text,
        "cli": (code, sorted(line.split()[0] for line in buf.getvalue().splitlines()[1:])),
    }
    if not (out["enabled"] and out["one"] == ["resources"] and out["unschedulable_counter"] and code == 0):
        raise AssertionError(f"/debug/explain: {out}")
    return out


def explain_drills(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``explain_drills``: each drill on ``device`` and again on the CPU,
    ending equal (module docstring, step 14). Returns the record and the
    card runs' B1 launches."""
    import torch

    from kube_batch_tpu_torch.ops import fused_solve as fs

    rec: dict = {"phase": "explain_drills", "device": device, "drills": {}}
    launches = 0
    for kind in EXPLAIN_DRILLS:
        out = {}
        for dev in dict.fromkeys((device, "cpu")):
            if dev != "cpu":
                torch.cuda.synchronize()
            b1 = fs.fused_solve.launches
            t0 = time.perf_counter()
            out[dev] = explain_drill(kind, dev)
            out[dev]["s"] = time.perf_counter() - t0
            if dev != "cpu":
                torch.cuda.synchronize()
                out[dev]["b1_launches"] = fs.fused_solve.launches - b1
                launches += out[dev]["b1_launches"]
                if not out[dev]["b1_launches"]:
                    raise AssertionError(f"{kind} on {dev} launched no B1")
        strip = lambda o: {k: v for k, v in o.items() if k not in ("s", "b1_launches")}  # noqa: E731
        if strip(out[device]) != strip(out["cpu"]):
            raise AssertionError(f"{kind}: the card's run ends otherwise than the CPU's: "
                                 f"{strip(out[device])} != {strip(out['cpu'])}")
        rec["drills"][kind] = out
    rec["b1_launches"] = launches
    return rec, (launches, 0)


def fleet_phase(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``fleet_smoke`` (module docstring, step 14)."""
    import torch

    from kube_batch_tpu_torch.obs import fleet
    from kube_batch_tpu_torch.ops import fused_solve as fs

    if device != "cpu":
        torch.cuda.synchronize()
    b1 = fs.fused_solve.launches
    t0 = time.perf_counter()
    r = fleet.smoke(shards=2, device=device)
    s = time.perf_counter() - t0
    b1 = fs.fused_solve.launches - b1
    if not r["ok"]:
        raise AssertionError(f"obs.fleet.smoke failed: {r}")
    rec = {"phase": "fleet_smoke", "device": device, "s": s, "b1_launches": b1,
           **{k: r[k] for k in ("shards", "pods", "bound", "exactly_once", "fsck_violations", "shards_scraped",
                                "scraped_after_kill", "killed_shard_detected", "counts_match", "within_bound",
                                "max_rel_err", "rel_err_bound", "alpha", "pods_per_second", "slo_compare")}}
    return rec, (b1, 0)


def admission_phase(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``admission_storm`` (module docstring, step 14)."""
    import torch

    from kube_batch_tpu_torch import admission
    from kube_batch_tpu_torch.ops import fused_solve as fs

    t0 = time.perf_counter()
    plant = admission.smoke()
    plant_s = time.perf_counter() - t0
    if not plant["ok"]:
        raise AssertionError(f"admission.smoke failed: {plant}")
    if device != "cpu":
        torch.cuda.synchronize()
    b1 = fs.fused_solve.launches
    t0 = time.perf_counter()
    row = admission.storm_row(shards=STORM_SHARDS, duration_s=STORM_S, device=device)
    storm_s = time.perf_counter() - t0
    b1 = fs.fused_solve.launches - b1
    if not row["ok"]:
        raise AssertionError(f"admission.storm_row failed: {row}")
    if device != "cpu" and b1 < 1:
        raise AssertionError("the storm's shards launched no B1")
    slo_s = 2.0  # the storm's KBT_ADMISSION_P99_SLO_S
    storms = {}
    for cell in ("on", "off", "kill"):
        r = row[cell]
        storms[cell] = {k: r[k] for k in ("offered", "admitted", "shed", "bound", "pods_per_s", "lane_p99_s",
                                          "cluster_p99_s", "micro_cycles", "mttr_s", "journal_orphans",
                                          "brownout_level_final", "exactly_once", "drained", "ok")}
    high = row["on"]["lane_p99_s"]["high"]
    rec = {"phase": "admission_storm", "device": device, "plant_s": plant_s, "storm_s": storm_s,
           "plant": {"on": plant["on"], "off": plant["off"]}, "storms": storms,
           "high_p99_s": high, "slo_s": slo_s, "high_p99_within_slo": high is not None and high <= slo_s,
           "b1_launches": b1}
    return rec, (b1, 0)


def operator_phases(device: str = "cuda", cut: int = 1) -> tuple[list[str], dict]:
    """The operator surfaces' phases: ``explain_50k_1k``, ``explain_drills``,
    ``fleet_smoke`` and ``admission_storm``. Returns the failures and the
    launches of each phase's main path."""
    failures, launches = [], {}

    def explained():
        rec, launches["explain_50k_1k"] = explain_phase(device, cut)
        emit(rec)

    def drills():
        rec, launches["explain_drills"] = explain_drills(device)
        emit(rec)

    def fleet():
        rec, launches["fleet_smoke"] = fleet_phase(device)
        emit(rec)

    def storm():
        rec, launches["admission_storm"] = admission_phase(device)
        emit(rec)

    t0 = time.perf_counter()
    run_phase(failures, "explain_50k_1k", explained)
    run_phase(failures, "explain_drills", drills)
    run_phase(failures, "fleet_smoke", fleet)
    run_phase(failures, "admission_storm", storm, drill=True)
    emit({"phase": "operator_phases_total", "s": time.perf_counter() - t0})
    return failures, launches


# -- the class-compressed solve (kernel B3) -----------------------------------

CLASS_WORLD = (400_000, 40_000)  # bench.py uniform_pool_400k_40k_classes: config 7 at full width
CLASS_CHURN = 0.01
# classes_400k_40k's pods are divided by this on the card, for the script's
# clock; its 40,000 nodes, the axis compression folds, are kept
CLASS_CUT = 1
CLASS_MIX = (50_000, 5_000)  # classes_50k_5k: preempt_mix, the low-duplication world
CLASS_ACTIONS = "enqueue, torch_allocate"
CLASS_SCORE_OPS_PER_SLOT = SCORE_OPS_PER_NODE + 2  # the class score adds the pod-affinity term
CLASS_TIMED_RUNS = 5
# class_step_vs_plain's padded slot axis: four slots a thread, and at R = 2
# past the shared-memory budget, so B3's global-memory form runs
CLASS_GLOBAL_CPAD = 4096
CLASS_DRILLS = ("a_parity", "b_class_table", "c_affinity", "d_micro_cycle", "e_explain")


class Compressing:
    """``KBT_CLASS_COMPRESS`` on or off for the block, restored after."""

    def __init__(self, on: bool) -> None:
        self.on = on

    def __enter__(self):
        from kube_batch_tpu_torch.ops import class_solve as cs

        self.saved = os.environ.get(cs.ENV)
        os.environ[cs.ENV] = "1" if self.on else "0"

    def __exit__(self, *exc):
        from kube_batch_tpu_torch.ops import class_solve as cs

        if self.saved is None:
            os.environ.pop(cs.ENV, None)
        else:
            os.environ[cs.ENV] = self.saved


# SolveStates the main paths returned, kept for ``signature_drift`` (step
# 16): entry -> (the state, the solver arrays of its world)
DRIFT: dict = {}


def class_launches() -> tuple[int, int, int]:
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import class_solve as cs
    from kube_batch_tpu_torch.ops import fused_solve as fs

    return fs.fused_solve.launches, bs.block_step.launches, cs.class_step.launches


def zero_launches() -> None:
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import class_solve as cs
    from kube_batch_tpu_torch.ops import fused_solve as fs

    fs.fused_solve.launches = bs.block_step.launches = cs.class_step.launches = 0


def class_session(cluster, device: str, compress: bool, action=None,
                  drift: str | None = None) -> tuple[dict, dict, object]:
    """One ``enqueue, torch_allocate`` session (the cycle conf's tiers) over
    a FakeCache of ``cluster``, with compression on or off, the launch
    counters zeroed just before and read just after; ``action`` is the
    torch_allocate object to run (its class table warm), else a fresh one.
    ``drift`` names the session's SolveState in ``DRIFT``. Returns (record,
    binds, the action)."""
    import torch

    from kube_batch_tpu_torch.analysis.trace import ArenaAudit
    from kube_batch_tpu_torch.ops import nvcc
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    on_card = device != "cpu"
    conf = conf_file(actions=CLASS_ACTIONS, device=device)
    with Compressing(compress):
        cache = FakeCache(cluster)
        sched = Scheduler(cache, conf)
        sched.actions = [action if action is not None and a.name == "torch_allocate" else type(a)()
                         for a in sched.actions]
        act = next(a for a in sched.actions if a.name == "torch_allocate")
        arena = act.arena_for(cache, device)
        if on_card:
            torch.cuda.synchronize()
        zero_launches()
        builds = nvcc.builds
        t0 = time.perf_counter()
        spent = [0.0]
        bare = arena.upload

        def timed_upload(*a, **k):  # the host time the session spends in the arena, under the audit
            t = time.perf_counter()
            try:
                return bare(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t

        arena.upload = timed_upload  # the audit wraps it, and its exit unwraps both
        with ArenaAudit(arena) as uploads:
            sched.run_once()
        if on_card:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        b1, b2, b3 = class_launches()
    if "aborted" in sched.last_timings:
        raise AssertionError(f"the session aborted: {sched.last_timings['aborted']}")
    binds = dict(cache.binder.binds)
    if drift is not None:
        from kube_batch_tpu_torch.solve import solver_inputs

        DRIFT[drift] = (act.last_state, solver_inputs(act.last_encoded, (1, 1, 1, 1)))
    stats = dict(act.last_class_stats or {})
    segment_ms = stats.pop("segment_ms", [])
    ta = dict(act.last_timings)
    rec = {
        "run_once_s": wall_s, "tier": act.last_solver_tier, "binds": len(binds),
        "solve_s": ta.get("solve_s"), "encode_s": ta.get("encode_s"), "pack_s": ta.get("pack_s"),
        "replay_s": ta.get("replay_s"), "fused_solve_s": ta.get("fused_solve_s"),
        "cycle": {k: v for k, v in sched.last_timings.items() if isinstance(v, (int, float))},
        "b1_launches": b1, "b2_launches": b2, "b3_launches": b3, "builds": nvcc.builds - builds,
        "arena": {k[len("arena_"):]: v for k, v in ta.items() if k.startswith("arena_")},
        "arena_upload_s": spent[0],
        "arena_uploads": {kind: sum(1 for r in uploads.records if r["kind"] == kind) for kind in ("reuse", "row", "full")},
    }
    if rec["arena"].get("failures"):
        raise AssertionError(f"the tensor arena failed: {rec['arena']}")
    if stats:
        rec["class"] = stats
    if segment_ms:
        rec["segment_ms"] = segment_summary(segment_ms)
    return rec, binds, act


def segment_summary(ms: list) -> dict:
    """B3's device time a launch over a session, in launch order: its
    quantiles and the means of the first and the second half of the
    launches (config 7's gangs place their first halves before their
    second halves, which select a job every iteration)."""
    import numpy as np

    a = np.asarray(ms, dtype=np.float64)
    half = len(a) // 2
    return {
        "launches": int(len(a)), "p10": float(np.quantile(a, 0.1)), "p50": float(np.median(a)),
        "p90": float(np.quantile(a, 0.9)), "max": float(a.max()),
        "first_half_mean": float(a[:half].mean()) if half else float(a.mean()),
        "second_half_mean": float(a[half:].mean()),
    }


def same_binds(name: str, want: dict, got: dict) -> None:
    if got != want:
        diff = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        raise AssertionError(f"{name}: {len(diff)} binds differ (of {len(want)}), first {diff[:3]}: "
                             f"{[(want.get(k), got.get(k)) for k in diff[:3]]}")


def classes_400k_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int, int], dict]:
    """``classes_400k_40k`` (module docstring, step 15). Returns the record,
    the launches and the encoded arrays of its snapshot."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.solve import solver_inputs

    on_card = device != "cpu"
    pods = CLASS_WORLD[0] // (CLASS_CUT if on_card else 1) // cut
    nodes = CLASS_WORLD[1] // cut
    t0 = time.perf_counter()
    cluster = models.uniform_pool(pods, nodes, churn=CLASS_CHURN)
    generate_s = time.perf_counter() - t0
    comp, comp_binds, act = class_session(cluster, device, True)
    if comp["tier"] != "class_fused" or "class" not in comp:
        raise AssertionError(f"the compressed session solved on the {comp['tier']!r} rung")
    if on_card and (comp["b3_launches"] < 1 or comp["b1_launches"] or comp["b2_launches"]):
        raise AssertionError(f"the compressed session launched B1 {comp['b1_launches']}, B2 {comp['b2_launches']}, "
                             f"B3 {comp['b3_launches']} times")
    arrays = solver_inputs(act.last_encoded, (1, 1, 1, 1))
    plain, plain_binds, _ = class_session(cluster, device, False)
    if plain["tier"] != "fused" or (on_card and (plain["b1_launches"] != 1 or plain["b3_launches"])):
        raise AssertionError(f"the uncompressed session: the {plain['tier']!r} rung, "
                             f"{plain['b1_launches']} B1 launches")
    same_binds("classes_400k_40k compressed against B1", plain_binds, comp_binds)
    if not comp_binds:
        raise AssertionError("classes_400k_40k bound nothing")
    del cluster
    # one churn session with a fresh salt on the same action: the warm table
    # re-keys the churned nodes, the slot bucket holds, nothing is built
    t0 = time.perf_counter()
    churned = models.uniform_pool(pods, nodes, churn=CLASS_CHURN, churn_salt=1)
    churn_generate_s = time.perf_counter() - t0
    churn, churn_binds, _ = class_session(churned, device, True, action=act)
    del churned
    if churn["tier"] != "class_fused" or churn["class"]["c_pad"] != comp["class"]["c_pad"]:
        raise AssertionError(f"the churn session: the {churn['tier']!r} rung, c_pad "
                             f"{churn['class'].get('c_pad')} against {comp['class']['c_pad']}")
    if churn["builds"] or comp["builds"] > 1:
        raise AssertionError(f"kernel builds: {comp['builds']} in the first session, {churn['builds']} in the churn one")
    if not churn_binds:
        raise AssertionError("the churn session bound nothing")
    st = comp["class"]
    b1_ms = (plain["fused_solve_s"] or 0.0) * 1e3
    rec = {
        "phase": "classes_400k_40k", "device": device, "pods": pods, "nodes": nodes, "generate_s": generate_s,
        "churn_generate_s": churn_generate_s,
        **{k: st[k] for k in ("class_count", "classes_valid", "compression_ratio", "splits", "remerges", "segments",
                              "c_pad", "group_s", "kernel_s")},
        "b3_device_ms": st["kernel_ms"], "b3_launches": comp["b3_launches"],
        "b3_ms_per_segment": st["kernel_ms"] / max(st["launches"], 1),
        "segment_ms_in_solve": st["kernel_s"] * 1e3 / max(st["launches"], 1),
        "b3_segment_ms": comp.get("segment_ms"),
        "solve_s": {"compressed": comp["solve_s"], "uncompressed": plain["solve_s"]},
        "run_once_s": {"compressed": comp["run_once_s"], "uncompressed": plain["run_once_s"]},
        "b1_ms": b1_ms, "compressed_over_b1_solve": comp["solve_s"] / plain["solve_s"] if plain["solve_s"] else None,
        "binds": len(comp_binds), "binds_equal": True,
        "arena_uploads": {"compressed": comp["arena_uploads"], "churn": churn["arena_uploads"]},
        "compressed": comp, "uncompressed": plain, "churn": churn,
    }
    print(f"classes_400k_40k arena uploads (class_* tables): {rec['arena_uploads']}", flush=True)
    if pods != CLASS_WORLD[0] or nodes != CLASS_WORLD[1]:
        rec["reduced"] = {"pods": [CLASS_WORLD[0], pods], "nodes": [CLASS_WORLD[1], nodes]}
    launches = (comp["b1_launches"] + plain["b1_launches"] + churn["b1_launches"], 0,
                comp["b3_launches"] + churn["b3_launches"])
    return rec, launches, arrays


def classes_50k_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int, int]]:
    """``classes_50k_5k``: preempt_mix compressed against B1."""
    from kube_batch_tpu_torch import models

    on_card = device != "cpu"
    pods, nodes = CLASS_MIX[0] // cut, CLASS_MIX[1] // cut
    cluster = models.preempt_mix(pods, nodes)
    comp, comp_binds, _ = class_session(cluster, device, True, drift="class_preempt_mix_50k_5k")
    plain, plain_binds, _ = class_session(cluster, device, False)
    if comp["tier"] != "class_fused" or plain["tier"] != "fused":
        raise AssertionError(f"rungs {comp['tier']!r} and {plain['tier']!r}")
    if on_card and (comp["b3_launches"] < 1 or plain["b1_launches"] != 1):
        raise AssertionError(f"{comp['b3_launches']} B3 and {plain['b1_launches']} B1 launches")
    same_binds("classes_50k_5k compressed against B1", plain_binds, comp_binds)
    st = comp["class"]
    rec = {
        "phase": "classes_50k_5k", "device": device, "pods": pods, "nodes": nodes,
        **{k: st[k] for k in ("class_count", "classes_valid", "compression_ratio", "splits", "remerges", "segments",
                              "c_pad", "group_s", "kernel_s")},
        "b3_device_ms": st["kernel_ms"], "b3_launches": comp["b3_launches"],
        "solve_s": {"compressed": comp["solve_s"], "uncompressed": plain["solve_s"]},
        "run_once_s": {"compressed": comp["run_once_s"], "uncompressed": plain["run_once_s"]},
        "binds": len(comp_binds), "binds_equal": True,
    }
    if cut > 1:
        rec["reduced"] = {"pods": [CLASS_MIX[0], pods], "nodes": [CLASS_MIX[1], nodes]}
    return rec, (comp["b1_launches"] + plain["b1_launches"], 0, comp["b3_launches"])


def class_segment_bytes(ca: dict, state, want, work: dict) -> int:
    """The bytes one B3 segment must move on this run's data, each input
    read once and each output written once: the entry's live slots (their
    InterPodAffinity columns for the popped tasks' groups only), the
    popped tasks' rows and those groups' compat and affinity rows, the
    member rows a split reads, every job and queue row when the segment
    selected (else the rows it changed), and every state element that
    changed, written."""
    import numpy as np

    from kube_batch_tpu_torch.ops import class_solve as cs

    def n(x) -> np.ndarray:
        return x.cpu().numpy()

    def row_bytes(x) -> int:
        return x[0].numel() * x.element_size()

    live = int((n(state.cmult) > 0).sum())
    ptr0, ptr1 = n(state.ptr), n(want.ptr)
    popped = np.concatenate([np.arange(a, b) for a, b in zip(ptr0, ptr1) if b > a] or [np.zeros(0, np.int64)])
    if int(want.paused_at) >= 0:
        popped = np.append(popped, int(want.paused_at))
    groups = np.unique(n(ca["task_gid"])[popped]).size
    nbytes = live * sum(row_bytes(getattr(state, f)) for f in cs.SLOT_FIELDS if f != "cpod_sc")
    nbytes += groups * live * state.cpod_sc.element_size()
    nbytes += popped.size * sum(row_bytes(ca[f]) for f in (
        "task_req", "task_res", "task_gid", "task_has_sc", "task_res_has_sc", "task_host_only", "task_ports"))
    nbytes += groups * (row_bytes(ca["compat"]) + row_bytes(ca["aff_sc"])) + ca["eps"].numel() * 4
    nbytes += (int(want.free_ptr) - int(state.free_ptr)) * 4  # members_sorted, one row a split
    job_in = [ca[f] for f in ("job_end", "job_min", "job_queue", "job_prio", "job_rank")]
    job_in += [getattr(state, f) for f in ("ptr", "ready_cnt", "job_active", "job_alloc")]
    queue_in = [ca[f] for f in ("queue_rank", "q_deserved", "q_dims")]
    queue_in += [getattr(state, f) for f in ("q_dropped", "q_alloc", "q_alloc_has_sc")]
    if work.get("selections", 0):
        nbytes += sum(x.numel() * x.element_size() for x in job_in + queue_in)
        nbytes += sum(ca[f].numel() * ca[f].element_size() for f in ("drf_total", "drf_dims"))
    else:
        jobs = int((ptr1 != ptr0).sum())
        nbytes += jobs * sum(row_bytes(x) for x in job_in + queue_in)
    for f in type(state)._fields:  # the writes: every element that changed
        a, b = n(getattr(state, f)), n(getattr(want, f))
        changed = a != b if a.dtype.kind != "f" else a.view(np.uint32) != b.view(np.uint32)
        nbytes += int(changed.sum()) * a.itemsize
    return int(nbytes)


# B3's time per iteration on the smallest slot bucket (a reading of B3, not
# its bound)
B3_FLOOR: dict = {}
B3_PROBE_ROWS = 64  # task rows the latency probe cycles through, in shared memory
B3_PROFILED_RUNS = 3
_PROBE: dict = {}


def probe_library():
    """The latency probe's library (csrc/class_floor.cu), built by the
    kernels' route (ops/nvcc.py) into the build directory, and its
    argument struct."""
    import ctypes

    from kube_batch_tpu_torch.ops import nvcc

    if not _PROBE:
        class FloorArgs(ctypes.Structure):
            _fields_ = ([(f, ctypes.c_int) for f in ("C", "R", "iterations", "rows", "nthreads", "smem_bytes")]
                        + [(f, ctypes.c_void_p) for f in ("slot_idle", "slot_used", "task_req", "task_res", "out")])

        def bind(lib):
            lib.kbt_class_floor.argtypes = [ctypes.POINTER(FloorArgs), ctypes.c_int, ctypes.c_void_p]
            lib.kbt_class_floor.restype = ctypes.c_int

        _PROBE.update(library=nvcc.Library("class_floor", bind), args=FloorArgs)
    return _PROBE["library"], _PROBE["args"]


def b3_latency_probe(ca: dict, state, want, threads: int, runs: int = CLASS_TIMED_RUNS) -> dict:
    """B3's latency bound: the probe of csrc/class_floor.cu (the dependent
    chain every single-CTA design pays an iteration: a task row read from
    shared memory, each slot's row read and scored from shared memory, a
    block arg-max with one barrier, an owner write) at the segment's slot
    count, B3's ``threads`` and the segment's iteration count, over its
    slot rows and popped task rows; the median device time of ``runs``
    launches after a first, CUDA events around each launch alone."""
    import ctypes

    import numpy as np
    import torch

    library, FloorArgs = probe_library()
    lib = library.load()
    dev = torch.device("cuda", 0)
    C, R = int(state.cmult.shape[0]), int(ca["task_req"].shape[1])
    iters = int(want.it) - int(state.it)
    ptr0, ptr1 = state.ptr.cpu().numpy(), want.ptr.cpu().numpy()
    popped = np.concatenate([np.arange(a, b) for a, b in zip(ptr0, ptr1) if b > a] or [np.zeros(0, np.int64)])
    popped = popped[:B3_PROBE_ROWS] if popped.size else np.arange(min(B3_PROBE_ROWS, ca["task_req"].shape[0]))
    rows = torch.from_numpy(popped.astype(np.int64))
    req = ca["task_req"].cpu()[rows].contiguous().to(dev)
    res = ca["task_res"].cpu()[rows].contiguous().to(dev)
    idle, used = state.cidle.contiguous().to(dev), state.cused.contiguous().to(dev)
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    smem = 4 * (2 * R * C + 2 * R * int(rows.numel()))
    args = FloorArgs(C=C, R=R, iterations=iters, rows=int(rows.numel()), nthreads=threads, smem_bytes=smem,
                     slot_idle=idle.data_ptr(), slot_used=used.data_ptr(), task_req=req.data_ptr(),
                     task_res=res.data_ptr(), out=out.data_ptr())
    stream = torch.cuda.current_stream(0).cuda_stream
    torch.cuda.synchronize()
    events = []
    for _ in range(runs + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.kbt_class_floor(ctypes.byref(args), 0, stream)
        end.record()
        if err != 0:
            raise AssertionError(f"the latency probe's launch failed: {library.error(err)}")
        events.append((start, end))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in events]
    if int(out[0]) < 0 and iters:
        raise AssertionError("the latency probe's sweep found no fitting slot")
    ms = statistics.median(times[1:])
    return {"latency_bound_ms": ms, "probe_ms_per_iteration": ms / max(iters, 1), "probe_runs_ms": times,
            "probe_threads": threads, "probe_c_pad": C, "probe_iterations": iters,
            "probe_rows": int(rows.numel())}


def b3_in_place(dca: dict, dstate, budget: int, max_iter: int, runs: int) -> tuple[list[float], list]:
    """B3 alone: ``runs`` launches, each over its own copy of ``dstate``
    made (and its ``ClassLaunch`` prepared) beforehand, back to back, CUDA
    events around each launch alone; returns the device times and the
    states the launches updated in place. Comparison launches: the
    counter is restored."""
    import torch

    from kube_batch_tpu_torch.ops import class_solve as cs

    saved = cs.class_step.launches
    copies = [cs.ClassSolveState(*(x.clone() for x in dstate)) for _ in range(runs)]
    prepared = [cs.ClassLaunch(dca, s, True, True, budget, max_iter) for s in copies]
    torch.cuda.synchronize()
    events = []
    for launch in prepared:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch.launch()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    cs.class_step.launches = saved
    return [s.elapsed_time(e) for s, e in events], copies


def b3_wrapper(dca: dict, dstate, budget: int, max_iter: int, runs: int) -> tuple[list[float], object]:
    """The functional wrapper ``class_step`` as the comparisons and tests
    call it (the state's copy, the argument block, the launch), CUDA events
    around the call, a synchronise after each; returns its times and the
    last result. Comparison launches: the counter is restored."""
    import torch

    from kube_batch_tpu_torch.ops import class_solve as cs

    saved = cs.class_step.launches
    times, got = [], None
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = cs.class_step(dca, dstate, True, True, budget, max_iter)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    cs.class_step.launches = saved
    return times, got


def b3_iteration_floor(name: str, arrays: dict, runs: int = CLASS_TIMED_RUNS) -> dict:
    """B3's own time per iteration on ``arrays``' entry segment (the
    smallest slot bucket ``class_step_vs_plain`` runs to its end): the
    slope of the kernel's device time (``b3_in_place``) between a
    one-iteration segment and the whole segment, each the median of
    ``runs`` launches after a first, so the launch's fixed cost drops out.
    The fixed cost splits into its device part (``fixed_ms``: the
    prologue's loads and the epilogue's write-back) and its host part
    (``host_fixed_ms``: the functional wrapper's time over the kernel's on
    the one-iteration segment). A reading of B3, not its bound."""
    import torch

    from kube_batch_tpu_torch.ops import class_solve as cs

    solver = cs.ClassCompressedSolver(cs.ClassTable(), arrays, True, True)
    state = solver._pack(solver._init_node_state())
    ca = solver._ca()
    max_iter = cs.max_iterations(ca)
    dev = torch.device("cuda", 0)
    dca = {k: (v if isinstance(v, float) else v.to(dev)) for k, v in ca.items()}
    dstate = cs.ClassSolveState(*(x.to(dev) for x in state))
    points = []
    for budget in (1, max(int(state.cmult.shape[0]) // 2, 1)):
        wrapper, got = b3_wrapper(dca, dstate, budget, max_iter, runs + 1)
        device, _ = b3_in_place(dca, dstate, budget, max_iter, runs + 1)
        points.append((statistics.median(device[1:]), statistics.median(wrapper[1:]), int(got.it) - int(state.it)))
    (d1, w1, n1), (d2, w2, n2) = points
    if n2 <= n1:
        raise AssertionError(f"{name}: the whole segment ran {n2} iterations, the one-iteration segment {n1}")
    per = (d2 - d1) / (n2 - n1)
    return {"world": name, "c_pad": int(state.cmult.shape[0]), "iterations": [n1, n2], "device_ms": [d1, d2],
            "wrapper_ms": [w1, w2], "ms_per_iteration": per, "fixed_ms": d1 - n1 * per, "host_fixed_ms": w1 - d1}


def same_class_state(name: str, want, got) -> float:
    """Every ClassSolveState field of ``got`` (any device) equal to
    ``want``'s (CPU), integers exactly and floats bit for bit; raises
    otherwise. Returns the largest absolute float difference (0.0)."""
    import numpy as np

    from kube_batch_tpu_torch.ops import class_solve as cs

    max_abs_err = 0.0
    for f in cs.ClassSolveState._fields:
        w, g = getattr(want, f).cpu().numpy(), getattr(got, f).cpu().numpy()
        if w.dtype != g.dtype or w.shape != g.shape:
            raise AssertionError(f"{name}: {f} is {g.dtype} {g.shape} on the card, {w.dtype} {w.shape} plain")
        if w.dtype.kind == "f":
            if not np.array_equal(w.view(np.uint32), g.view(np.uint32)):
                bad = np.flatnonzero(w.view(np.uint32).ravel() != g.view(np.uint32).ravel())[:5]
                raise AssertionError(f"{name}: {f} differs at {bad.tolist()}: card {g.ravel()[bad].tolist()} "
                                     f"plain {w.ravel()[bad].tolist()}")
            if w.size:
                max_abs_err = max(max_abs_err, float(np.abs(w.astype(np.float64) - g).max()))
        elif not np.array_equal(w, g):
            bad = np.flatnonzero(w.ravel() != g.ravel())[:5]
            raise AssertionError(f"{name}: {f} differs at {bad.tolist()}: card {g.ravel()[bad].tolist()} "
                                 f"plain {w.ravel()[bad].tolist()}")
    return max_abs_err


def class_step_vs_plain(
    name: str, arrays: dict, overflow: bool = False, timed_runs: int = 1, cpad: int | None = None,
    headline: bool = False,
) -> dict:
    """Kernel B3 (card) against class_step_plain (CPU) on one segment
    packed from ``arrays``' entry state, the segment budget the packed
    bucket's half; with ``overflow`` the slot axis cut to its live slots,
    so the first split overflows; with ``cpad`` the slot axis padded with
    dead slots to ``cpad`` (past the threads a thread owns several, and
    past the shared-memory budget the working state is in global
    memory). Every ClassSolveState field equal, integers exactly and
    floats bit for bit, for the functional wrapper and for every in-place
    launch; raises otherwise. Times B3 alone (``device_ms``, the median
    of the in-place launches after a first) and the functional wrapper
    (``wrapper_ms``). With ``headline``: also the profiler's device time
    of B3 (``profiler_device_ms``) and the latency probe's bound."""
    import torch

    from kube_batch_tpu_torch.analysis.trace import no_sync
    from kube_batch_tpu_torch.ops import class_solve as cs

    solver = cs.ClassCompressedSolver(cs.ClassTable(), arrays, True, True)
    state = solver._pack(solver._init_node_state())
    ca = solver._ca()
    budget = max(int(state.cmult.shape[0]) // 2, 1)
    if overflow:
        fp = int(state.free_ptr)
        cut = {f: getattr(state, f)[:fp].clone() for f in cs.SLOT_FIELDS if f != "cpod_sc"}
        cut["cpod_sc"] = state.cpod_sc[:, :fp].clone()
        state = state._replace(**cut)
    if cpad is not None:
        state = cs.grow_slots(state, cpad)
    work: dict = {}
    t0 = time.perf_counter()
    want = cs.class_step_plain(ca, state, True, True, budget, work=work)
    plain_ms = (time.perf_counter() - t0) * 1e3
    dev = torch.device("cuda", 0)
    dca = {k: (v if isinstance(v, float) else v.to(dev)) for k, v in ca.items()}
    dstate = cs.ClassSolveState(*(x.to(dev) for x in state))
    saved = cs.class_step.launches
    max_iter = cs.max_iterations(ca)
    torch.cuda.synchronize()
    with no_sync():  # the launch alone, inputs on the card: no torch-side sync
        cs.class_step(dca, dstate, True, True, budget, max_iter)
        cs.class_step_inplace(dca, cs.ClassSolveState(*(x.clone() for x in dstate)), True, True, budget, max_iter)
    cs.class_step.launches = saved
    wrapper, got = b3_wrapper(dca, dstate, budget, max_iter, timed_runs)
    device, updated = b3_in_place(dca, dstate, budget, max_iter, max(timed_runs, 2))
    max_abs_err = same_class_state(name, want, got)
    for k, s in enumerate(updated):
        same_class_state(f"{name}, in-place launch {k}", want, s)
    rec_extra: dict = {}
    if headline:
        copies = [cs.ClassSolveState(*(x.clone() for x in dstate)) for _ in range(B3_PROFILED_RUNS)]
        prepared = iter([cs.ClassLaunch(dca, s, True, True, budget, max_iter) for s in copies])
        rec_extra["profiler_device_ms"] = kernel_device_ms(lambda: next(prepared).launch(), B3_PROFILED_RUNS,
                                                           "class_step_kernel")
        cs.class_step.launches = saved
    if overflow and not bool(want.overflow):
        raise AssertionError(f"{name}: the cut slot axis did not overflow")
    C, R = int(state.cmult.shape[0]), int(ca["task_req"].shape[1])
    threads, smem_bytes, in_smem = cs.geometry(C, int(ca["queue_rank"].shape[0]), R, int(ca["compat"].shape[0]),
                                                int(ca["job_min"].shape[0]))
    if cpad is not None and cpad > cs.MAX_THREADS and threads >= C:
        raise AssertionError(f"{name}: {C} slots on {threads} threads is no stride")
    if headline:
        t0 = time.perf_counter()
        rec_extra.update(b3_latency_probe(ca, state, want, threads))
        rec_extra["probe_s"] = time.perf_counter() - t0  # the probe's library load and its launches
    iters = int(want.it) - int(state.it)
    nbytes = class_segment_bytes(ca, state, want, work)
    ops = work.get("fit_slots", 0) * FIT_OPS_PER_DIM * R + work.get("scored_slots", 0) * CLASS_SCORE_OPS_PER_SLOT
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    device_ms = device[-1] if len(device) < 3 else statistics.median(device[1:])
    wrapper_ms = wrapper[-1] if timed_runs == 1 else statistics.median(wrapper[1:])
    return {
        "world": name, "T": int(ca["task_req"].shape[0]), "N": int(ca["members_sorted"].shape[0]),
        "C": int(state.free_ptr), "c_pad": C, "seg_budget": budget, "R": R,
        "threads": threads, "working_bytes": smem_bytes, "in_smem": in_smem,
        "iterations": iters, "assigned": int(want.step) - int(state.step),
        "splits": int(want.free_ptr) - int(state.free_ptr),
        "overflow": bool(want.overflow), "paused_at": int(want.paused_at),
        "device_ms": device_ms, "ms_per_iteration": device_ms / max(iters, 1), "device_runs_ms": device,
        "wrapper_ms": wrapper_ms, "wrapper_runs_ms": wrapper,
        "plain_ms": plain_ms, "max_abs_err": max_abs_err, "bytes": nbytes, "ops": ops, **work,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "match": True, "in_place_match": len(updated), "launch_without_sync": True, **rec_extra,
    }


def class_drill(kind: str, device: str) -> dict:
    """One of ``class_drills`` on ``device``; returns what the CPU run must
    equal (binds, records) beside its own checks' readings."""
    import json as _json

    from kube_batch_tpu_torch import faults, metrics
    from kube_batch_tpu_torch.actions.allocate import AllocateAction
    from kube_batch_tpu_torch.actions.torch_allocate import TorchAllocateAction
    from kube_batch_tpu_torch.ops import class_solve as cs

    kind_dev = "cuda" if device != "cpu" else "cpu"
    fused = {"torch_allocate": {"device": device, "min_device_pairs": "0"}}
    out: dict = {"drill": kind}
    if kind == "a_parity":
        # serial = fused = class_fused = class_sharded, over two cycles with
        # arrivals (cycle 1's placements resident in cycle 2)
        sharded = {"torch_allocate": {"device": device, "mesh": f"{kind_dev}:2"}}
        world = cs._smoke_world()
        for cycle in (1, 2):
            sides, tiers = {}, {}
            sides["serial"] = cs._smoke_run(AllocateAction(), world)
            for side, on, args in (("fused", False, fused), ("class_fused", True, fused),
                                   ("class_sharded", True, sharded)):
                with Compressing(on):
                    act = TorchAllocateAction()
                    sides[side] = cs._smoke_run(act, world, args)
                    tiers[side] = act.last_solver_tier
            if tiers != {"fused": "fused", "class_fused": "class_fused", "class_sharded": "class_sharded"}:
                raise AssertionError(f"cycle {cycle}: rungs {tiers}")
            for side, binds in sides.items():
                same_binds(f"a_parity cycle {cycle} {side}", sides["serial"], binds)
            out[f"binds_cycle{cycle}"] = sides["serial"]
            world = cs._smoke_world(bound=sides["serial"], arrivals=6)
    elif kind == "b_class_table":
        with Compressing(False):
            want = cs._smoke_run(TorchAllocateAction(), cs._smoke_world(), fused)
        labels = {"tier": "class_solve", "reason": "class_table"}
        before = metrics.degraded_cycles.value(labels)
        faults.registry.arm("solve.class_table", count=1)
        try:
            with Compressing(True):
                act = TorchAllocateAction()
                got = cs._smoke_run(act, cs._smoke_world(), fused)
        finally:
            faults.registry.reset()
        same_binds("b_class_table", want, got)
        if act.last_solver_tier != "fused" or act.last_class_stats is not None:
            raise AssertionError(f"b_class_table: the {act.last_solver_tier!r} rung")
        if metrics.degraded_cycles.value(labels) != before + 1:
            raise AssertionError("b_class_table: the degrade was not counted")
        out["binds"] = got
    elif kind == "c_affinity":
        from kube_batch_tpu_torch.apis.types import Affinity, PodAffinityTerm, PodPhase
        from kube_batch_tpu_torch.testing import (
            build_cluster,
            build_node,
            build_pod,
            build_pod_group,
            build_queue,
            build_resource_list,
        )

        def world():
            anchor = build_pod(name="anchor", node_name="n0", phase=PodPhase.RUNNING,
                               req=build_resource_list(cpu=1, memory="128Mi"), labels={"app": "db"})
            pods, groups = [anchor], []
            for i in range(12):
                p = build_pod(name=f"p{i}", group_name=f"g{i}", req=build_resource_list(cpu=1, memory="256Mi"))
                p.metadata.creation_timestamp = float(i)
                if i in (4, 9):
                    p.affinity = Affinity(pod_affinity_required=[PodAffinityTerm(label_selector={"app": "db"})])
                pg = build_pod_group(f"g{i}", min_member=1)
                pg.metadata.creation_timestamp = float(i)
                pods.append(p)
                groups.append(pg)
            nodes = [build_node(f"n{i}", build_resource_list(cpu=8, memory="8Gi", pods=20)) for i in range(4)]
            return build_cluster(pods, nodes, groups, [build_queue("default")])

        with Compressing(False):
            want = cs._smoke_run(TorchAllocateAction(), world(), fused)
        with Compressing(True):
            act = TorchAllocateAction()
            got = cs._smoke_run(act, world(), fused)
        same_binds("c_affinity", want, got)
        if act.last_solver_tier != "class_fused" or act.last_timings.get("host_steps") != 2 or len(got) != 12:
            raise AssertionError(f"c_affinity: the {act.last_solver_tier!r} rung, "
                                 f"{act.last_timings.get('host_steps')} host steps, {len(got)} binds")
        out["binds"] = got
    elif kind == "d_micro_cycle":
        from kube_batch_tpu_torch.conf import parse_scheduler_conf
        from kube_batch_tpu_torch.framework import close_session, open_session
        from kube_batch_tpu_torch.streaming import StreamState, open_micro_session
        from kube_batch_tpu_torch.testing import FakeCache

        tiers = parse_scheduler_conf(cs._SMOKE_TIERS).tiers

        def arrival_jobs():
            # two arrival gangs, as _smoke_world's arrivals (the same names
            # and shapes as the full-cycle reference's), as a session holds them
            ssn = open_session(FakeCache(cs._smoke_world(arrivals=2)), tiers)
            jobs = {uid: j for uid, j in ssn.jobs.items() if j.name.startswith("arrival-")}
            queues = dict(ssn.queues)
            close_session(ssn, discard=True)
            return jobs, queues

        def micro(compress):
            with Compressing(compress):
                act = TorchAllocateAction()
                cache = FakeCache(cs._smoke_world())
                ssn = open_session(cache, tiers, fused)
                act.execute(ssn)
                st = StreamState()
                st.adopt_full_cycle(ssn)
                close_session(ssn)
                full = dict(cache.binder.binds)
                jobs, queues = arrival_jobs()
                mssn = open_micro_session(cache, tiers, fused, jobs, st.nodes, queues)
                mssn.micro_cycle = True
                act.execute(mssn)
                close_session(mssn)
                return full, {k: v for k, v in cache.binder.binds.items() if k not in full}, act.last_solver_tier

        full_c, micro_c, tier = micro(True)
        full_p, micro_p, _ = micro(False)
        # the reference: one full cycle over cycle 1's placements and the arrivals
        with Compressing(False):
            one = cs._smoke_run(TorchAllocateAction(), cs._smoke_world(bound=full_p, arrivals=2), fused)
        same_binds("d_micro_cycle full cycle", full_p, full_c)
        same_binds("d_micro_cycle compressed micro against uncompressed", micro_p, micro_c)
        same_binds("d_micro_cycle micro against one full cycle", one, micro_c)
        if tier != "class_fused" or len(micro_c) != 4:
            raise AssertionError(f"d_micro_cycle: the {tier!r} rung, {len(micro_c)} arrivals bound")
        out["binds"] = micro_c
    elif kind == "e_explain":
        from kube_batch_tpu_torch.obs import explain

        def records(compress):
            with Compressing(compress), Explaining(True):
                act = TorchAllocateAction()
                binds = cs._smoke_run(act, explain._smoke_world(), fused)
                recs = sorted(explain.records.snapshot(), key=lambda r: _json.dumps(r, sort_keys=True))
            return binds, act.last_solver_tier, _json.dumps(recs, sort_keys=True)

        plain_binds, _, plain_recs = records(False)
        comp_binds, tier, comp_recs = records(True)
        same_binds("e_explain", plain_binds, comp_binds)
        if tier != "class_fused" or comp_recs != plain_recs or '"unschedulable"' not in comp_recs:
            raise AssertionError(f"e_explain: the {tier!r} rung; records equal: {comp_recs == plain_recs}")
        out["records"] = comp_recs
        out["binds"] = comp_binds
    else:
        raise ValueError(kind)
    return out


def class_drills(device: str = "cuda") -> tuple[dict, tuple[int, int, int]]:
    """``class_drills`` (a)-(e), each on ``device`` and again on the CPU,
    ending equal."""
    rec: dict = {"phase": "class_drills", "device": device, "drills": {}}
    totals = [0, 0, 0]
    for kind in CLASS_DRILLS:
        t0 = time.perf_counter()
        zero_launches()
        got = class_drill(kind, device)
        n = class_launches()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = class_drill(kind, "cpu") if device != "cpu" else got
        if cpu != got:
            raise AssertionError(f"{kind}: the card's run and the CPU's differ")
        rec["drills"][kind] = {"s": card_s, "cpu_s": time.perf_counter() - t0, "launches": list(n)}
        for i in range(3):
            totals[i] += n[i]
    if device != "cpu" and totals[2] < 1:
        raise AssertionError("the class drills launched B3 no time")
    rec["launches"] = totals
    return rec, tuple(totals)


def class_phases(device: str = "cuda", cut: int = 1) -> tuple[list[str], dict, list[dict]]:
    """The class-compressed solve's phases: ``classes_400k_40k``,
    ``classes_50k_5k``, ``class_step_vs_plain`` (on the card) and
    ``class_drills``. Returns the failures, the launches (B1, B2, B3) of
    each phase's main path and B3's comparison records."""
    failures, launches, b3 = [], {}, []
    shared: dict = {}

    def big():
        rec, launches["classes_400k_40k"], shared["arrays"] = classes_400k_phase(device, cut)
        emit(rec)

    def mix():
        rec, launches["classes_50k_5k"] = classes_50k_phase(device, cut)
        emit(rec)

    def versus():
        from kube_batch_tpu_torch.ops import class_solve as cs
        from kube_batch_tpu_torch.solve import solver_arrays

        small = solver_arrays(cs._smoke_world())[1]
        cases = [("smoke_world", small, False, 3, None), ("smoke_world_overflow", small, True, 1, None),
                 ("smoke_world_global", small, False, 1, CLASS_GLOBAL_CPAD)]
        if "arrays" in shared:
            big = shared.pop("arrays")
            cases[:0] = [("uniform_pool_400k_40k_segment", big, False, CLASS_TIMED_RUNS, None),
                         ("uniform_pool_400k_40k_segment_global", big, False, 3, CLASS_GLOBAL_CPAD)]
        for name, arrays, overflow, runs, cpad in cases:
            rec = class_step_vs_plain(name, arrays, overflow, runs, cpad, headline=name.endswith("_40k_segment"))
            if cpad is not None and rec["in_smem"]:
                raise AssertionError(f"{name}: {cpad} slots did not take B3's global-memory form")
            b3.append(rec)
            emit({"phase": "class_step_vs_plain", **rec})
        B3_FLOOR.update(b3_iteration_floor("smoke_world", small))
        emit({"phase": "class_step_floor", **B3_FLOOR})

    def drills():
        rec, launches["class_drills"] = class_drills(device)
        emit(rec)

    t0 = time.perf_counter()
    run_phase(failures, "classes_400k_40k", big)
    run_phase(failures, "classes_50k_5k", mix)
    if device != "cpu":
        run_phase(failures, "class_step_vs_plain", versus)
    run_phase(failures, "class_drills", drills, drill=True)
    emit({"phase": "class_phases_total", "s": time.perf_counter() - t0})
    return failures, launches, b3


def signature_drift_phase() -> dict:
    """``signature_drift`` (step 16): KBT-P002 and KBT-P005 on the
    SolveStates the fused, sharded and class main paths returned
    (``DRIFT``), each against the entry state of the CPU plain version on
    the same world (``init_state``: the protocol every rung resumes from).
    Runs no solve."""
    import numpy as np

    from kube_batch_tpu_torch.analysis import trace
    from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
    from kube_batch_tpu_torch.ops.kernels import init_state

    t0 = time.perf_counter()
    rungs = {"fused", "sharded@1", "sharded@4", "class"}
    seen = {entry.split("_")[0] for entry in DRIFT}
    if not rungs <= seen:
        raise AssertionError(f"signature_drift: no SolveState of the {sorted(rungs - seen)} rung(s)")
    findings, fields = [], 0
    for entry, (state, arrays) in sorted(DRIFT.items()):
        if any(isinstance(v, np.ndarray) for v in arrays.values()):
            arrays = arrays_from_numpy(arrays)
        ref = init_state(arrays, True, True)  # on the CPU: the plain version's entry state
        path = trace.rung_path(entry.split("_")[0])
        findings += trace.check_f64(state, entry, path)
        findings += trace.check_signature_drift(trace.state_signature(ref), trace.state_signature(state),
                                                "plain_entry", entry, path)
        fields += len(state._fields)
    if findings:
        raise AssertionError("signature drift:\n" + "\n".join(f.render() for f in findings))
    return {"phase": "signature_drift", "states": sorted(DRIFT), "fields_checked": fields,
            "equal": True, "float64_fields": 0, "s": time.perf_counter() - t0}


def interleave_card_phase(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``interleave_card`` (step 16): ``dispatch_vs_next_solve`` through
    every schedule with its torch_allocate on the card (B1 launched in
    every schedule), each clean and equal to the CPU explorer's: schedule
    count, trace ids and per-schedule binds. Returns the record and the
    card run's B1 and B2 launches."""
    from kube_batch_tpu_torch.analysis import interleave
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs

    scenario = "dispatch_vs_next_solve"
    t0 = time.perf_counter()
    want = interleave.explore(scenario, device="cpu")
    t1 = time.perf_counter()
    fs.fused_solve.launches = bs.block_step.launches = 0
    got = interleave.explore(scenario, device=device)
    launches = (fs.fused_solve.launches, bs.block_step.launches)
    t2 = time.perf_counter()
    if got.counterexamples or want.counterexamples:
        raise AssertionError(f"{scenario}: counterexamples on the card {[r.trace for r in got.counterexamples]}, "
                             f"on the CPU {[r.trace for r in want.counterexamples]}")
    summary = [(r.trace, r.violations, r.fingerprint) for r in got.results]
    if (got.schedules, summary) != (want.schedules, [(r.trace, r.violations, r.fingerprint) for r in want.results]):
        raise AssertionError(f"{scenario}: the card's schedules differ from the CPU explorer's")
    if device != "cpu" and (launches[0] < got.schedules or launches[1]):
        raise AssertionError(f"{scenario}: {launches[0]} B1 and {launches[1]} B2 launches over {got.schedules} schedules")
    return {
        "phase": "interleave_card", "scenario": scenario, "device": device, "schedules": got.schedules,
        "traces": [r.trace for r in got.results], "clean": True, "equal_to_cpu": True,
        "b1_launches": launches[0], "cpu_s": t1 - t0, "card_s": t2 - t1,
    }, launches


def analyzer_phases(device: str = "cuda") -> tuple[list[str], dict]:
    """The analyzers' card phases after the main paths: ``signature_drift``
    and ``interleave_card`` (``trace_audit_50k_5k`` runs beside the warm
    cycles). Returns the failures and the launches of each phase's main
    path."""
    failures, launches = [], {}

    def interleave_card():
        rec, launches["interleave_card"] = interleave_card_phase(device)
        emit(rec)

    t0 = time.perf_counter()
    run_phase(failures, "signature_drift", lambda: emit(signature_drift_phase()))
    run_phase(failures, "interleave_card", interleave_card)
    emit({"phase": "analyzer_phases_total", "s": time.perf_counter() - t0})
    return failures, launches


def classes_only(card: str, kind: str) -> int:
    """``--classes``: the kernels' build and the class-compressed solve's
    phases alone (step 15)."""
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import class_solve as cs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc

    t_start = time.perf_counter()
    logs = nvcc.build(["fused_solve", "block_step", "class_step", "class_floor"])
    fs._library.load()
    bs._library.load()
    cs._library.load()
    emit({"phase": "build", "s": time.perf_counter() - t_start,
          "ptxas": {name: ptxas_summary(log) for name, log in logs.items()}})
    emit(native_build())
    failures, launches, _ = class_phases()
    emit({"phase": "total", "s": time.perf_counter() - t_start, "launches": {k: list(v) for k, v in launches.items()}})
    if failures:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failures), file=sys.stderr, flush=True)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})
    return 0


def pipeline_uncut(card: str, kind: str) -> int:
    """``--pipeline-uncut``: pipeline_fused_50k_1k uncut and
    pipeline_reclaim at 50,000 pods on the card, the cost of the uncut
    preempt walk and reclaim pass (minutes of host work; not part of the
    smoke run)."""
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc

    t_start = time.perf_counter()
    nvcc.build(["fused_solve", "block_step"])
    fs._library.load()
    bs._library.load()
    failures, _ = pipeline_phases({}, {}, reclaim_pods=50_000, walk_cut=1,
                                  only=("pipeline_fused_50k_1k", "pipeline_reclaim"))
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    if failures:
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})
    return 0


def federation_only(card: str, kind: str) -> int:
    """``--federation``: the kernels' build and the federation's three
    phases alone (``federation_50k_5k`` computes its own FakeCache
    reference cycle)."""
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc

    t_start = time.perf_counter()
    nvcc.build(["fused_solve", "block_step"])
    fs._library.load()
    bs._library.load()
    emit(native_build())
    failures, launches = federation_phases()
    emit({"phase": "total", "s": time.perf_counter() - t_start, "launches": {k: list(v) for k, v in launches.items()}})
    if failures:
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})
    return 0


def operator_only(card: str, kind: str) -> int:
    """``--operator``: the kernels' build and the operator surfaces' four
    phases alone (step 14)."""
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc

    t_start = time.perf_counter()
    nvcc.build(["fused_solve", "block_step"])
    fs._library.load()
    bs._library.load()
    emit(native_build())
    failures, launches = operator_phases()
    emit({"phase": "total", "s": time.perf_counter() - t_start, "launches": {k: list(v) for k, v in launches.items()}})
    if failures:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failures), file=sys.stderr, flush=True)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})
    return 0


def streaming_only(card: str, kind: str) -> int:
    """``--streaming``: the kernels' build and the streaming scheduler's
    three phases alone (step 13)."""
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc

    t_start = time.perf_counter()
    nvcc.build(["fused_solve", "block_step"])
    fs._library.load()
    bs._library.load()
    emit(native_build())
    failures, launches = streaming_phases()
    emit({"phase": "total", "s": time.perf_counter() - t_start, "launches": {k: list(v) for k, v in launches.items()}})
    if failures:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failures), file=sys.stderr, flush=True)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})
    return 0


def rehearse(argv: list[str]) -> int:
    """``--rehearse CUT``: the pipeline, fast-path, ladder, trace and process
    phases on the CPU, every world's pod and node counts divided by CUT,
    torch_allocate on the kernels' plain versions. A prediction of the
    host actions' cost, not a measurement of the card. ``--rehearse CUT
    --cards``: the multi-card phases alone, on ``mesh: cpu:4``."""
    try:
        cut = int(argv[1]) if len(argv) in (2, 3) and argv[2:] in ([], ["--cards"]) else 0
    except ValueError:
        cut = 0
    if cut < 2:
        print("chip_smoke: usage: chip_smoke.py --rehearse CUT [--cards] (CUT an integer of 2 or more)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    if argv[2:] == ["--cards"]:
        failures = multichip_phases(device="cpu", cut=cut)
        emit({"phase": "total", "s": time.perf_counter() - t0, "cut": cut})
        return 1 if failures else 0
    emit(native_build())
    failures, _ = pipeline_phases({}, {}, device="cpu", cut=cut)
    fast_failures, _ = fast_path_phases({}, {}, device="cpu", cut=cut)
    failures += fast_failures + degradation_failures()
    ladder_failures, _ = ladder_trace_phases({}, {}, device="cpu", cut=cut)
    failures += ladder_failures
    shared: dict = {}
    server_failures, _ = server_phases(device="cpu", cut=cut, shared=shared)
    failures += server_failures
    fed_failures, _ = federation_phases(device="cpu", cut=cut, shared=shared)
    failures += fed_failures
    stream_failures, _ = streaming_phases(device="cpu", cut=cut)
    failures += stream_failures
    operator_failures, _ = operator_phases(device="cpu", cut=cut)
    failures += operator_failures
    class_failures, _, _ = class_phases(device="cpu", cut=cut)
    failures += class_failures
    emit({"phase": "total", "s": time.perf_counter() - t0, "cut": cut})
    return 1 if failures else 0


AB_WARM_CODE = ("import json, sys; sys.path.insert(0, '.'); import chip_smoke as c; "
                "rec, _ = c.warm_cycles_phase('cuda'); print('AB_WARM ' + json.dumps(rec))")


def ab_warm(other: str) -> int:
    """``--ab-warm DIR``: ``warm_cycles_50k_5k`` of the checkout at DIR (the
    parent commit, unpacked with ``git archive``) against this checkout's,
    in the order DIR, this, this, DIR, each in a process of its own on the
    card, tracing off (the default). One record per run: each cycle's
    ``run_once`` and collector time, fast paths on and off."""
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    failed = 0
    for run, tree in enumerate((other, here, here, other)):
        out = subprocess.run([sys.executable, "-c", AB_WARM_CODE], cwd=tree, capture_output=True, text=True,
                             timeout=900)
        line = next((x for x in out.stdout.splitlines() if x.startswith("AB_WARM ")), None)
        if out.returncode != 0 or line is None:
            failed += 1
            print(f"chip_smoke: ab_warm run {run} in {tree} exited {out.returncode}: {out.stderr[-2000:]}",
                  file=sys.stderr)
            continue
        rec = json.loads(line[len("AB_WARM "):])
        emit({"phase": "ab_warm", "run": run, "tree": "this" if tree == here else "other",
              **{arm: {"run_once_s": [c["run_once_s"] for c in rec[arm]], "gc_s": [c["gc_s"] for c in rec[arm]]}
                 for arm in ("fast", "off")}, "b1_launches": rec["b1_launches"]})
    return 1 if failed else 0


AB_B4_CODE = """
import json, sys, time
sys.path.insert(0, '.')
import torch
from kube_batch_tpu_torch.parallel import ShardedBlockSolver, make_mesh
arrays = torch.load(sys.argv[1])
mesh = list(make_mesh())
torch.cuda.set_device(0)
runs = []
for k in (4, 4):
    solver = ShardedBlockSolver(arrays, mesh, True, True, exchange_batch=k)
    t0 = time.perf_counter()
    state = solver.solve()
    runs.append({'k': k, 's': time.perf_counter() - t0, 'device_ms_by_card': solver._mesh.device_ms,
                 'exchange_rounds': solver.counts['exchange_rounds'],
                 'placing_iterations': solver.counts['placing_iterations'],
                 'assigned_node_sum': int(state.assigned_node.long().sum())})
print('AB_B4 ' + json.dumps(runs))
"""


def ab_b4(other: str) -> int:
    """``--ab-b4 DIR``: B4 at K = BATCHED_K over every visible card on
    ``preempt_mix(50_000, 5_000)``, the checkout at DIR (the parent
    commit, unpacked with ``git archive``) against this one, in the order
    DIR, this, this, DIR, each in a process of its own (its kernels built
    from its own sources), two solves a process, each card's kernel time
    (CUDA events); the world is encoded once here and loaded by each
    process. One record a run; the runs' placements must agree."""
    import tempfile

    import torch

    from kube_batch_tpu_torch import models

    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    if torch.cuda.device_count() < 2:
        raise AssertionError("--ab-b4 needs two or more cards")
    path = os.path.join(tempfile.gettempdir(), f"kbt_ab_b4_{os.getpid()}.pt")
    torch.save(encoded_arrays(models.preempt_mix(50_000, 5_000)), path)
    failed, sums = 0, set()
    try:
        for run, tree in enumerate((other, here, here, other)):
            out = subprocess.run([sys.executable, "-c", AB_B4_CODE, path], cwd=tree, capture_output=True, text=True,
                                 timeout=900)
            line = next((x for x in out.stdout.splitlines() if x.startswith("AB_B4 ")), None)
            if out.returncode != 0 or line is None:
                failed += 1
                print(f"chip_smoke: ab_b4 run {run} in {tree} exited {out.returncode}: {out.stderr[-2000:]}",
                      file=sys.stderr)
                continue
            runs = json.loads(line[len("AB_B4 "):])
            sums.update(r["assigned_node_sum"] for r in runs)
            emit({"phase": "ab_b4", "run": run, "tree": "this" if tree == here else "other",
                  "world": "preempt_mix_50k_5k", "k": BATCHED_K, "runs": runs})
    finally:
        os.remove(path)
    if len(sums) > 1:
        print(f"chip_smoke: ab_b4: the trees' placements differ ({sorted(sums)})", file=sys.stderr)
        failed += 1
    return 1 if failed else 0


# -- the multi-card deployment: the twin of the multi-chip conf over cards ----

MULTICHIP_CONF = "scheduler-conf-torch-multichip.yaml"
MULTICHIP_WORLD = (50_000, 5_000)  # preempt_mix: the cycle, warm, pipelined and class phases
MULTICHIP_EXPLAIN = (50_000, 1_000)  # explain_50k_1k's world
MULTICHIP_SESSIONS = 2  # pipelined sessions back to back over a mesh
REHEARSE_SHARDS = 4  # the CPU rehearsal's mesh: cpu:4


class Multichip:
    """Where the multi-card phases run, by arm:

    - ``cards``: the twin conf's mesh, on the card ``mesh: auto`` as the
      file says (every visible card, one shard each), on the CPU
      ``mesh: cpu:4`` with ``device: cpu``;
    - ``one_card``: the same conf with every shard of the resolved mesh on
      the first card (``OnFirstCard``), the same shard count;
    - ``reference``: ``mesh: off`` on cuda:0 (the CPU), the fused rung.

    ``card`` is every card's ``nvidia-smi`` line ("cpu" in a rehearsal)."""

    def __init__(self, device: str = "cuda", cut: int = 1, card: str = "cpu") -> None:
        import torch

        self.on_card = device != "cpu"
        self.cut = cut
        self.card = card
        n = torch.cuda.device_count() if self.on_card else REHEARSE_SHARDS
        self.m = 1 << (n.bit_length() - 1)  # torch_allocate clamps auto to a power of two
        self.ref_device = "cuda:0" if self.on_card else "cpu"
        self.mesh_args = {} if self.on_card else {"mesh": f"cpu:{REHEARSE_SHARDS}", "device": "cpu"}

    def conf(self, arm: str, actions: str | None = None, **args) -> str:
        if arm == "reference":
            return conf_file(base=MULTICHIP_CONF, actions=actions, mesh="off", device=self.ref_device, **args)
        return conf_file(base=MULTICHIP_CONF, actions=actions, **self.mesh_args, **args)

    def world(self, shape: tuple[int, int]):
        from kube_batch_tpu_torch import models

        return models.preempt_mix(shape[0] // self.cut, shape[1] // self.cut)

    def reduced(self, shape: tuple[int, int]) -> dict:
        if self.cut == 1:
            return {}
        return {"reduced": {"pods": [shape[0], shape[0] // self.cut], "nodes": [shape[1], shape[1] // self.cut]}}

    def sync(self) -> None:
        import torch

        if self.on_card:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def check(self, name: str, arm: str, rec: dict, tier: str = "sharded") -> None:
        """The arm's cycle ran where it should: the reference on the fused
        rung; a mesh arm on ``m`` shards at ``tier``, on the sharded rung by
        B4 (``cards``, ``one_card``) or by the host loop (``host_loop``),
        and on the card with no B1 launch and: B4 once a solve segment on
        each of the mesh's cards, no B2 and no host read; or, on the host
        loop, B2 once a placing iteration on each shard's card and one host
        read of the records a card and placing iteration (the CPU reads
        none: its records lie on the host)."""
        if arm == "reference":
            if rec["tier"] != "fused" or rec["mesh_size"] != 1:
                raise AssertionError(f"{name} reference: the {rec['tier']!r} rung on a mesh of {rec['mesh_size']}")
            return
        if rec["mesh_size"] != self.m or rec["tier"] != tier:
            raise AssertionError(f"{name} {arm}: the {rec['tier']!r} rung on a mesh of {rec['mesh_size']}, "
                                 f"expected {tier!r} on {self.m}")
        if tier != "sharded":
            return
        impl = "host_loop" if arm == "host_loop" else "mesh_kernel"
        if rec["sharded_impl"] != impl:
            raise AssertionError(f"{name} {arm}: the sharded rung ran {rec['sharded_impl']!r}, expected {impl!r}")
        if not self.on_card:
            return
        placing = rec["placing_iterations"]
        if arm == "host_loop":
            cards = {f"cuda:{i}": placing for i in range(self.m)}
            reads = placing * self.m
            if rec["b1_launches"] or rec["b2_launches_by_card"] != cards or rec["record_reads"] != reads:
                raise AssertionError(f"{name} {arm}: {rec['b1_launches']} B1 launches, B2 by card "
                                     f"{rec['b2_launches_by_card']} and {rec['record_reads']} record reads for "
                                     f"{placing} placing iterations; expected 0, {cards} and {reads}")
            return
        segments = 1 + rec["host_steps"]
        cards = {f"cuda:{i}": segments for i in range(self.m)} if arm == "cards" else {"cuda:0": segments}
        if (rec["b1_launches"] or rec["b2_launches"] or rec["b4_launches_by_card"] != cards
                or rec["record_reads"]):
            raise AssertionError(f"{name} {arm}: {rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches, B4 "
                                 f"by card {rec['b4_launches_by_card']} and {rec['record_reads']} record reads; "
                                 f"expected 0, 0, {cards} and 0")


class OnFirstCard:
    """While entered, torch_allocate's resolved mesh keeps its size with
    every shard on its first device: the mesh of one card beside the mesh
    over cards, from the same conf."""

    def __init__(self, on: bool = True) -> None:
        self.on = on

    def __enter__(self) -> None:
        from kube_batch_tpu_torch.actions import torch_allocate as ta

        self.real = ta.TorchAllocateAction._resolve
        if not self.on:
            return
        real = self.real

        def resolve(action, args):
            device, mesh = real(action, args)
            return device, None if mesh is None else (mesh[0],) * len(mesh)

        ta.TorchAllocateAction._resolve = resolve

    def __exit__(self, *exc) -> None:
        from kube_batch_tpu_torch.actions import torch_allocate as ta

        ta.TorchAllocateAction._resolve = self.real


class HostLoop:
    """While entered, torch_allocate's sharded rung runs the host loop over
    B2 with K = 1 (``ShardedBlockSolver(..., impl="host_loop")``, which no
    conf reaches): B4's plain version at full width, on the cards."""

    def __init__(self, on: bool = True) -> None:
        self.on = on

    def __enter__(self) -> None:
        from kube_batch_tpu_torch.actions import torch_allocate as ta

        self.real = ta.ShardedBlockSolver
        if not self.on:
            return

        class Forced(self.real):
            def __init__(self, *args, **kwargs) -> None:
                super().__init__(*args, **{**kwargs, "impl": "host_loop"})

        ta.ShardedBlockSolver = Forced

    def __exit__(self, *exc) -> None:
        from kube_batch_tpu_torch.actions import torch_allocate as ta

        ta.ShardedBlockSolver = self.real


def by_card(counter) -> dict:
    return {f"cuda:{i}": n for i, n in sorted(counter.items()) if n}


def card_delta(after, before) -> dict:
    """A by-card counter's growth across a region, keyed as ``by_card``."""
    return by_card({i: n - before.get(i, 0) for i, n in after.items()})


def mc_scheduler(conf: str, cluster):
    """A Scheduler over ``FakeCache(cluster)`` with actions of its own (the
    registry's objects keep state across schedulers: the class table)."""
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    sched = Scheduler(FakeCache(cluster), conf)
    sched.actions = [type(a)() for a in sched.actions]
    return sched


def mc_cycle(ctx: Multichip, arm: str, sched, read_states: bool = True) -> tuple[dict, dict]:
    """One ``sched.run_once()`` in ``arm``, every launch counter (by card
    too) zeroed just before and read just after, and with ``read_states``
    every task's state read before the session closes (not under
    ``KBT_PIPELINE``: the deferred dispatch may be writing the session
    then). Returns the record (wall clock, the action's split, the sharded
    rung's counts, launches by card) and the outcome (binds, evicts,
    states)."""
    import collections

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import class_solve as cs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import mesh_solve as ms

    states: dict = {}
    close = sched_mod.close_session

    def close_reading_states(ssn, discard=False):
        states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values() for t in j.tasks.values()})
        close(ssn, discard=discard)

    kernels = (fs.fused_solve, bs.block_step, cs.class_step)
    ctx.sync()
    if read_states:
        sched_mod.close_session = close_reading_states
    for k in kernels:
        k.launches = 0
        k.launches_by_card.clear()
    b4 = ms.mesh_solve  # counted by difference: run_phase reads its total
    b4_before = (b4.launches, collections.Counter(b4.launches_by_card), collections.Counter(b4.device_ms_by_card))
    try:
        with OnFirstCard(arm == "one_card"), HostLoop(arm == "host_loop"), GcClock() as gc_clock:
            t0 = time.perf_counter()
            sched.run_once()
            ctx.sync()
            wall_s = time.perf_counter() - t0
    finally:
        sched_mod.close_session = close
    if "aborted" in sched.last_timings:
        raise AssertionError(f"{arm}: the cycle aborted: {sched.last_timings['aborted']}")
    act = next(a for a in sched.actions if a.name == "torch_allocate")
    t, counts = act.last_timings, act.last_counts
    placing = counts.get("placing_iterations", 0)
    cache = sched.cache
    rec = {
        "arm": arm, "run_once_s": wall_s, "tier": act.last_solver_tier, "mesh_size": act.last_mesh_size,
        **{k: t.get(k) for k in ("encode_s", "pack_s", "solve_s", "loop_s", "select_s", "exchange_s", "update_s",
                                 "replay_s", "explain_s")},
        "placing_iterations": placing, "record_reads": counts.get("record_reads", 0),
        "record_reads_per_placing_iteration": counts.get("record_reads", 0) / placing if placing else None,
        "b1_launches": fs.fused_solve.launches, "b2_launches": bs.block_step.launches,
        "b3_launches": cs.class_step.launches, "b1_launches_by_card": by_card(fs.fused_solve.launches_by_card),
        "b2_launches_by_card": by_card(bs.block_step.launches_by_card),
        "b3_launches_by_card": by_card(cs.class_step.launches_by_card),
        "b4_launches": b4.launches - b4_before[0], "b4_launches_by_card": card_delta(b4.launches_by_card, b4_before[1]),
        "b4_device_ms_by_card": card_delta(b4.device_ms_by_card, b4_before[2]),
        "sharded_impl": t.get("sharded_impl"), "exchange_batch": t.get("exchange_batch"),
        "exchange_rounds": counts.get("exchange_rounds", 0), "speculated": counts.get("speculated", 0),
        "host_steps": t.get("host_steps", 0),
        "binds": len(cache.binder.binds), "evicts": len(cache.evictor.evicts),
        "cycle": {k: v for k, v in sched.last_timings.items() if isinstance(v, (int, float))}, **gc_clock.record(),
    }
    return rec, {"binds": dict(cache.binder.binds), "evicts": list(cache.evictor.evicts), "states": states}


def mc_equal(name: str, want: dict, got: dict, keys=("binds", "evicts", "states")) -> None:
    for key in keys:
        if got[key] != want[key]:
            if key == "binds":
                same_binds(name, want[key], got[key])
            raise AssertionError(f"{name}: the {key} differ from the reference's")


def mc_record(ctx: Multichip, name: str, arms: dict, **extra) -> dict:
    """A phase's record: ``m``, the cards, each arm's record (the mesh over
    cards under ``cards``, its shards on one card under ``one_card``)."""
    return {"phase": name, "m": ctx.m, "card": ctx.card, "device": "cuda" if ctx.on_card else "cpu", **arms,
            **extra}


def multichip_cycle_phase(ctx: Multichip, base) -> dict:
    """``multichip_cycle_50k_5k``: the twin conf (``mesh: auto`` on the
    card, loaded from its file) through one ``Scheduler.run_once`` on
    ``preempt_mix(50_000, 5_000)``, the reclaim and preempt walks at
    ``pipeline_fused_50k_5k``'s depth; binds, evictions and task states
    equal the same conf's with ``mesh: off`` on cuda:0, on every arm: B4
    over the cards, B4 on one card, and the host loop over B2 over the
    cards (B4's plain version at full width)."""
    arms, want = {}, None
    for arm in ("reference", "cards", "one_card", "host_loop"):
        rec, got = mc_cycle(ctx, arm, mc_scheduler(ctx.conf(arm), session_cluster(base)))
        ctx.check("multichip_cycle_50k_5k", arm, rec)
        if want is None:
            want = got
        else:
            mc_equal(f"multichip_cycle_50k_5k {arm}", want, got)
        arms[arm] = rec
    pipelined = sum(1 for s, _ in want["states"].values() if s == "PIPELINED")
    return mc_record(ctx, "multichip_cycle_50k_5k", arms, pipelined=pipelined, equal_to_reference=True,
                     **ctx.reduced(MULTICHIP_WORLD))


def arena_placement(arena) -> dict:
    """The sharded rung's static slabs in the arena (B4's ``mesh_*``, one
    row a card; the host loop's ``sharded_*``, one part a shard): each
    part's device and data pointer, by slab."""
    out = {}
    for (name, _bank), slot in arena._slots.items():
        if name.startswith(("sharded_", "mesh_")):
            out[name] = [(str(t.device), t.data_ptr()) for t in slot.device]
    return out


def multichip_warm_phase(ctx: Multichip) -> dict:
    """``multichip_warm_cycles_50k_5k``: ``warm_cycles_50k_5k``'s three
    cycles (cold; nothing changed; 1% of the nodes relabelled and a new
    gang) of one Scheduler over the twin conf, each arm on a world of its
    own. B4's three ``mesh_*`` slabs lie one row on each of the mesh's
    cards; cycle 2 reuses every one of them on every card (no upload, the
    same buffers); the binds and task states equal the reference's cycle by
    cycle."""
    from kube_batch_tpu_torch.ops import encode_cache

    arms, want = {}, None
    for arm in ("reference", "cards", "one_card"):
        sched = mc_scheduler(ctx.conf(arm), ctx.world(MULTICHIP_WORLD))
        cluster = sched.cache.cluster
        encode_cache.get().invalidate_all("chip_smoke")
        cycles, outcomes, placed = [], [], []
        for cycle in range(3):
            if cycle == 2:
                nodes = cluster.nodes
                for node_name in sorted(nodes)[: max(int(len(nodes) * CHURN), 1)]:
                    relabel(nodes[node_name], "churn")
                add_gang(cluster, "multichip-new-gang", 8)
            rec, got = mc_cycle(ctx, arm, sched)
            ctx.check(f"multichip_warm_cycles_50k_5k cycle {cycle + 1}", arm, rec)
            act = next(a for a in sched.actions if a.name == "torch_allocate")
            rec["arena"] = {k[len("arena_"):]: v for k, v in act.last_timings.items() if k.startswith("arena_")}
            if rec["arena"].get("failures"):
                raise AssertionError(f"{arm} cycle {cycle + 1}: the tensor arena failed: {rec['arena']}")
            if arm != "reference":
                placed.append(arena_placement(act._arena))
                rec["arena_cards"] = {name: sorted({d for d, _ in parts}) for name, parts in placed[-1].items()}
            cycles.append(rec)
            outcomes.append(got)
        if arm != "reference":
            cards = [f"cuda:{k}" for k in range(ctx.m)] if ctx.on_card and arm == "cards" else [
                "cuda:0" if ctx.on_card else "cpu"]
            for name, parts in placed[0].items():
                if [d for d, _ in parts] != cards:
                    raise AssertionError(f"{arm}: arena slab {name} on {[d for d, _ in parts]}, expected {cards}")
            if sorted(placed[0]) != ["mesh_fstatic", "mesh_gidx", "mesh_istatic"]:
                raise AssertionError(f"{arm}: {sorted(placed[0])} in the arena, expected B4's three mesh_* slabs")
            a2 = cycles[1]["arena"]
            if a2.get("full_uploads") or a2.get("row_updates") or a2.get("reuses", 0) < 3 or placed[1] != placed[0]:
                raise AssertionError(f"{arm} cycle 2 (nothing changed) did not reuse every static block: {a2}")
        if want is None:
            want = outcomes
        else:
            for cycle, (w, g) in enumerate(zip(want, outcomes)):
                mc_equal(f"multichip_warm_cycles_50k_5k {arm} cycle {cycle + 1}", w, g)
        arms[arm] = cycles
    return mc_record(ctx, "multichip_warm_cycles_50k_5k", arms, binds_by_cycle=[len(o["binds"]) for o in want],
                     equal_cycle_for_cycle=True, **ctx.reduced(MULTICHIP_WORLD))


def multichip_pipelined_phase(ctx: Multichip, base) -> dict:
    """``multichip_pipelined_50k_5k``: ``pipelined_50k_5k``'s sessions
    (``torch_allocate`` alone, a fresh FakeCache each) with
    ``KBT_PIPELINE`` on over the mesh, MULTICHIP_SESSIONS back to back (the
    next session's run joins the last one's deferred dispatch), the sharded
    rung at K = 4 from the K rule (the conf names no ``exchange_batch``, as
    the JAX deployment runs under ``KBT_PIPELINE``); every session's binds
    equal the synchronous run's (``mesh: off`` on cuda:0, the pipeline
    off), each session deferred its dispatch, nothing degraded."""
    from kube_batch_tpu_torch import pipeline

    saved = os.environ.get(pipeline.ENV)
    arms, want = {}, None
    try:
        for arm in ("reference", "cards", "one_card"):
            on = arm != "reference"
            os.environ[pipeline.ENV] = "1" if on else "0"
            pipeline.reset()
            runs, scheds = [], []
            for _ in range(MULTICHIP_SESSIONS if on else 1):
                sched = mc_scheduler(ctx.conf(arm, actions="torch_allocate"), session_cluster(base))
                rec, _ = mc_cycle(ctx, arm, sched, read_states=False)
                ctx.check("multichip_pipelined_50k_5k", arm, rec)
                if on and rec["exchange_batch"] != BATCHED_K:  # the K rule under KBT_PIPELINE
                    raise AssertionError(f"{arm}: the sharded rung ran K={rec['exchange_batch']}, expected {BATCHED_K}")
                runs.append(rec)
                scheds.append(sched)
            if not pipeline.fence.wait():
                raise AssertionError(f"{arm}: the last dispatch did not land: {pipeline.fence.degraded_reason}")
            for i, (rec, sched) in enumerate(zip(runs, scheds)):
                act = next(a for a in sched.actions if a.name == "torch_allocate")
                rec["deferred_replay_s"] = act.last_timings.get("replay_s") if on else None
                binds = dict(sched.cache.binder.binds)
                rec["binds"] = len(binds)  # the deferred dispatch has landed: read again
                if want is None:
                    want = binds
                elif binds != want:
                    same_binds(f"multichip_pipelined_50k_5k {arm} session {i}", want, binds)
                if on and not (rec["deferred_replay_s"] or 0) > 0:
                    raise AssertionError(f"{arm} session {i}: no dispatch was deferred")
            if pipeline.fence.degraded_reason:
                raise AssertionError(f"{arm}: the pipeline degraded: {pipeline.fence.degraded_reason}")
            arms[arm] = runs[0] if arm == "reference" else {"runs": runs, "run_once_s": [r["run_once_s"] for r in runs]}
    finally:
        if saved is None:
            os.environ.pop(pipeline.ENV, None)
        else:
            os.environ[pipeline.ENV] = saved
        pipeline.reset()
    return mc_record(ctx, "multichip_pipelined_50k_5k", arms, sessions=MULTICHIP_SESSIONS, binds=len(want),
                     binds_equal=True, **ctx.reduced(MULTICHIP_WORLD))


def multichip_explain_phase(ctx: Multichip) -> dict:
    """``multichip_explain_50k_1k``: ``explain_50k_1k``'s world through
    ``enqueue, torch_allocate`` (the twin conf's tiers) with
    ``KBT_EXPLAIN`` on, on the sharded rung over the mesh; the published
    records equal the fused rung's on cuda:0 as canonical JSON, and so do
    the binds."""
    from kube_batch_tpu_torch.obs import explain

    cluster = ctx.world(MULTICHIP_EXPLAIN)
    arms, want = {}, None
    for arm in ("reference", "cards", "one_card"):
        with Explaining(True):
            rec, got = mc_cycle(ctx, arm, mc_scheduler(ctx.conf(arm, actions="enqueue, torch_allocate"),
                                                       session_cluster(cluster)))
            records = {r["gang"]: r for r in explain.records.snapshot()}
        ctx.check("multichip_explain_50k_1k", arm, rec)
        got["records"] = canon(records)
        rec["gangs_explained"] = len(records)
        if rec["gangs_explained"] < 1:
            raise AssertionError(f"{arm}: no gang was explained")
        if want is None:
            want = got
        else:
            mc_equal(f"multichip_explain_50k_1k {arm}", want, got, keys=("binds", "states", "records"))
        arms[arm] = rec
    return mc_record(ctx, "multichip_explain_50k_1k", arms, records_equal=True, **ctx.reduced(MULTICHIP_EXPLAIN))


def multichip_classes_phase(ctx: Multichip, base) -> dict:
    """``multichip_classes_50k_5k``: ``classes_50k_5k``'s world through
    ``enqueue, torch_allocate`` with ``KBT_CLASS_COMPRESS`` on over the
    mesh: the class table on the mesh's first card (tier
    ``class_sharded``); binds and task states equal B1's uncompressed on
    cuda:0, and on the card B3 launched on cuda:0 alone, B1 and B2 never.
    The mesh over cards runs with the last card current for the thread
    (as ``Scheduler.run(device=...)`` makes it), not the table's."""
    import contextlib

    import torch

    arms, want = {}, None
    for arm in ("reference", "cards", "one_card"):
        current = ctx.m - 1 if ctx.on_card and arm == "cards" else None
        with Compressing(arm != "reference"), (
                contextlib.nullcontext() if current is None else torch.cuda.device(current)):
            sched = mc_scheduler(ctx.conf(arm, actions=CLASS_ACTIONS), session_cluster(base))
            rec, got = mc_cycle(ctx, arm, sched)
        act = next(a for a in sched.actions if a.name == "torch_allocate")
        stats = act.last_class_stats or {}
        rec.update(current_card=current, b3_kernel_ms=stats.get("kernel_ms"), segments=stats.get("segments"))
        ctx.check("multichip_classes_50k_5k", arm, rec, tier="class_sharded")
        if ctx.on_card and arm != "reference" and (rec["b1_launches"] or rec["b2_launches"] or rec["b4_launches"]
                                                   or set(rec["b3_launches_by_card"]) != {"cuda:0"}):
            raise AssertionError(f"{arm}: {rec['b1_launches']} B1, {rec['b2_launches']} B2 and {rec['b4_launches']} "
                                 f"B4 launches, B3 by card {rec['b3_launches_by_card']}; expected B3 on cuda:0 alone")
        if want is None:
            want = got
        else:
            mc_equal(f"multichip_classes_50k_5k {arm}", want, got, keys=("binds", "states"))
        arms[arm] = rec
    return mc_record(ctx, "multichip_classes_50k_5k", arms, binds_equal=True, **ctx.reduced(MULTICHIP_WORLD))


def multichip_ladder_phase(ctx: Multichip) -> dict:
    """``multichip_ladder``: ``ladder_drills`` (c) over the mesh. On
    ``preempt_mix(2000, 40, seed=1)`` the ``solve.sharded`` fault point
    fires once after the sharded rung ran its segment over the cards; the
    fused rung resumes on the conf's device (cuda:0) in the same cycle
    with one B1 launch; the ``sharded`` breaker counts one failure and
    makes no transition; binds, evictions and task states equal an
    undisturbed fused cycle's."""
    from kube_batch_tpu_torch import faults, models

    pods, nodes, seed = DRILL_WORLD
    process_ladder = faults.solver_ladder
    arms, want = {}, None
    try:
        for arm in ("reference", "cards", "one_card"):
            faults.registry.reset()
            ladder = faults.DegradationLadder(("sharded", "fused", "serial"), failure_threshold=3,
                                              reset_timeout=DRILL_RESET_S, clock=DrillClock())
            history = []
            for b in ladder.breakers.values():
                real = b._transition

                def transition(to, b=b, real=real):
                    history.append((b.name, b.state, to))
                    real(to)

                b._transition = transition
            faults.set_solver_ladder(ladder)
            if arm != "reference":
                faults.registry.arm("solve.sharded", count=1)
            rec, got = mc_cycle(ctx, arm, mc_scheduler(ctx.conf(arm, min_device_pairs=0),
                                                       models.preempt_mix(pods, nodes, seed=seed)))
            rec.update(history=history, sharded_failures=ladder.breakers["sharded"].failures)
            ctx.check("multichip_ladder", "reference", {**rec, "mesh_size": 1})  # every arm ends on the fused rung
            if arm != "reference":
                if rec["mesh_size"] != ctx.m or rec["sharded_failures"] != 1 or history:
                    raise AssertionError(f"{arm}: sharded breaker {rec['sharded_failures']} failures, {history}")
                if ctx.on_card:
                    cards = {f"cuda:{k}" for k in range(ctx.m)} if arm == "cards" else {"cuda:0"}
                    if rec["b1_launches_by_card"] != {"cuda:0": 1} or set(rec["b4_launches_by_card"]) != cards:
                        raise AssertionError(f"{arm}: B1 by card {rec['b1_launches_by_card']}, B4 by card "
                                             f"{rec['b4_launches_by_card']}; expected one B1 on cuda:0 after B4 "
                                             f"on {sorted(cards)}")
            if want is None:
                want = got
            else:
                mc_equal(f"multichip_ladder {arm}", want, got)
            arms[arm] = rec
    finally:
        faults.registry.reset()
        faults.set_solver_ladder(process_ladder)
    return mc_record(ctx, "multichip_ladder", arms, world=f"preempt_mix({pods}, {nodes}, seed={seed})",
                     equal_to_undisturbed=True)


def multichip_trace_phase(ctx: Multichip) -> dict:
    """``multichip_trace_audit``: the trace audit's sharded solve
    (``preempt_mix(2000, 40, seed=1)``, as ``analysis.trace`` runs it on
    one card) over the mesh, on kernel B4, under torch's sync debug mode
    ``"warn"`` with every B4 launch group under ``"error"``: the syncs by
    site, none a placing iteration (the exchange runs inside the launches)
    and one barrier a card in ``MeshSolve.solve``; no host read of any
    record. The result equals the fused rung's field for field. The CPU
    has no sync audit: it runs the solves and counts the reads (none)."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.analysis import trace
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver, make_mesh
    from kube_batch_tpu_torch.solve import solver_arrays

    import torch

    arrays = solver_arrays(models.preempt_mix(*trace.WARM_WORLD, seed=1))[1]
    a = arrays_from_numpy(arrays)
    want = fs.FusedSolver(a, True, True, device=ctx.ref_device).solve()
    first = torch.device(ctx.ref_device)
    meshes = {"cards": make_mesh(ctx.m) if ctx.on_card else (first,) * ctx.m, "one_card": (first,) * ctx.m}
    arms = {}
    for arm, mesh in meshes.items():
        solver = ShardedBlockSolver(a, mesh, True, True)
        bs.block_step.launches = 0
        b4 = ms.mesh_solve.launches
        ctx.sync()
        t0 = time.perf_counter()
        if ctx.on_card:
            with trace.guard_calls(ms, "_launch_cards") as guarded, trace.SyncAudit() as audit:
                got = solver.solve()
        else:
            got = solver.solve()
        ctx.sync()
        solve_s = time.perf_counter() - t0
        same_state(f"multichip_trace_audit {arm}", want, got)
        placing, reads = solver.counts["placing_iterations"], solver.counts["record_reads"]
        cards = len(set(mesh)) if ctx.on_card else 1
        rec = {"arm": arm, "mesh": [str(d) for d in mesh], "s": solve_s, **solver.timings, **solver.counts,
               "record_reads_per_placing_iteration": reads / placing, "b2_launches": bs.block_step.launches,
               "b4_launches": ms.mesh_solve.launches - b4, "b4_device_ms_by_card": solver._mesh.device_ms}
        if ctx.on_card:
            exchange = sum(n for (_, _, q), n in audit.sites.items() if q == "ShardedBlockSolver._exchange")
            barrier = sum(n for (_, _, q), n in audit.sites.items() if q == "MeshSolve.solve")
            rec.update(syncs=audit.total, exchange_syncs=exchange, mesh_solve_syncs=barrier,
                       b4_launch_groups_without_sync=guarded["calls"],
                       sites={f"{p}:{ln} {q}": n for (p, ln, q), n in sorted(audit.sites.items())})
            for site, n in rec["sites"].items():
                print(f"multichip_trace_audit {arm} sync site {site}: {n}", flush=True)
            if (exchange or reads or rec["b2_launches"] or guarded["calls"] != 1 or rec["b4_launches"] != cards
                    or barrier > cards or audit.total >= placing):
                raise AssertionError(f"{arm}: {exchange} syncs and {reads} reads in _exchange, {barrier} in "
                                     f"MeshSolve.solve, {audit.total} in all for {placing} placing iterations, "
                                     f"{rec['b2_launches']} B2 launches and {rec['b4_launches']} B4 launches in "
                                     f"{guarded['calls']} groups; expected 0, 0, at most {cards}, a handful, 0 and "
                                     f"{cards} in 1")
        elif reads:
            raise AssertionError(f"{arm}: {reads} record reads on the CPU")
        else:
            rec["p001"] = "not run: the sync audit needs a card"
        arms[arm] = rec
    return mc_record(ctx, "multichip_trace_audit", arms, world=f"preempt_mix{trace.WARM_WORLD}, seed=1",
                     equal_to_fused=True)


def multichip_phases(device: str = "cuda", cut: int = 1, card: str = "cpu") -> list[str]:
    """The multi-card deployment (``--cards``): the twin of
    ``scheduler-conf-tpu-multichip.yaml`` through the whole pipeline on
    every visible card, seven phases, each held to a reference computed in
    this run, each arm timed beside the same mesh with its shards on
    cuda:0. ``device="cpu"`` with ``cut`` > 1 is the CPU rehearsal
    (``mesh: cpu:4``). Returns the failures."""
    ctx = Multichip(device, cut, card)
    failures: list = []
    base = ctx.world(MULTICHIP_WORLD)

    for name, fn in (
        ("multichip_cycle_50k_5k", lambda: multichip_cycle_phase(ctx, base)),
        ("multichip_warm_cycles_50k_5k", lambda: multichip_warm_phase(ctx)),
        ("multichip_pipelined_50k_5k", lambda: multichip_pipelined_phase(ctx, base)),
        ("multichip_explain_50k_1k", lambda: multichip_explain_phase(ctx)),
        ("multichip_classes_50k_5k", lambda: multichip_classes_phase(ctx, base)),
        ("multichip_ladder", lambda: multichip_ladder_phase(ctx)),
        ("multichip_trace_audit", lambda: multichip_trace_phase(ctx)),
    ):
        run_phase(failures, name, lambda fn=fn: emit(fn()), drill=name == "multichip_ladder")
    return failures


MESH_FLOOR_ITERATIONS = 20_000  # exchanges a mesh_floor run passes between the cards


def mesh_floor_probe(cards: int, runs: int = 2, k: int = 0, on_one_device: bool = False) -> dict:
    """``mesh_floor``: csrc/mesh_floor.cu on the first ``cards`` cards, each
    run MESH_FLOOR_ITERATIONS exchanges of B4's stamped records through
    peer memory (one CTA of 512 threads a card, launched on every card
    before any is waited on; CUDA events around each card's launch on its
    stream); with ``k`` > 0 rounds of the batched exchange, ``k`` records a
    card; ``on_one_device``: the ``cards`` cards all on cuda:0, a stream
    each, as ``b4_cards`` lays out four cards of one solve. Returns the
    microseconds an exchange or round, per card and run; the last run's
    slowest card is the exchange's latency a placing iteration (a round's
    at ``k``)."""
    import ctypes

    import torch

    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.ops import nvcc

    class MeshFloorArgs(ctypes.Structure):
        """Mirror of `struct MeshFloorArgs` in csrc/mesh_floor.cu."""

        _fields_ = [("m", ctypes.c_int), ("card", ctypes.c_int), ("iterations", ctypes.c_int),
                    ("timeout_ms", ctypes.c_int), ("epoch", ctypes.c_uint), ("K", ctypes.c_int),
                    ("xbuf", ctypes.c_void_p * ms.MAX_CARDS), ("out", ctypes.c_void_p)]

    nvcc.build(["mesh_floor"])
    lib = ctypes.CDLL(nvcc.library_path("mesh_floor"))
    lib.kbt_mesh_floor.argtypes = [ctypes.POINTER(MeshFloorArgs), ctypes.c_int, ctypes.c_void_p]
    devs = [0] * cards if on_one_device else list(range(cards))
    if not on_one_device:
        ms.enable_peer_access([torch.device("cuda", i) for i in devs])
    bufs = [torch.zeros(ms.XBUF_WORDS, dtype=torch.int32, device=f"cuda:{i}") for i in devs]
    outs = [torch.zeros(2, dtype=torch.int32, device=f"cuda:{i}") for i in devs]
    streams = [torch.cuda.Stream(device=i) if on_one_device else torch.cuda.current_stream(i) for i in devs]
    for i in set(devs):
        torch.cuda.synchronize(i)
    table = (ctypes.c_void_p * ms.MAX_CARDS)(*[b.data_ptr() for b in bufs])
    us = []
    for run in range(runs):
        events = []
        for c, i in enumerate(devs):
            args = MeshFloorArgs(m=cards, card=c, iterations=MESH_FLOOR_ITERATIONS, timeout_ms=ms.TIMEOUT_MS,
                                 epoch=run * (MESH_FLOOR_ITERATIONS + 1), K=k, xbuf=table, out=outs[c].data_ptr())
            stream = streams[c]
            with torch.cuda.device(i):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record(stream)
                if lib.kbt_mesh_floor(ctypes.byref(args), i, stream.cuda_stream) != 0:
                    raise AssertionError(f"mesh_floor: the launch on cuda:{i} failed")
                end.record(stream)
            events.append((start, end))
        for i in set(devs):
            torch.cuda.synchronize(i)
        done = [int(o[0]) for o in outs]
        if done != [MESH_FLOOR_ITERATIONS] * cards or len({int(o[1]) for o in outs}) != 1:
            raise AssertionError(f"mesh_floor: cards finished {done} exchanges with winners {outs}")
        us.append([s.elapsed_time(e) * 1e3 / MESH_FLOOR_ITERATIONS for s, e in events])
    return {"phase": "mesh_floor", "cards": cards, "k": k, "on_one_device": on_one_device,
            "iterations": MESH_FLOOR_ITERATIONS,
            "us_per_exchange": us, "exchange_us": max(us[-1])}


BATCHED_K = 4  # the K of B4's batched exchange over the cards (the K rule's default)
BATCHED_PREFIX = 64  # its plain comparison's jobs prefix (a quarter of K = 1's: speculation sweeps more)


def b4_batched_over_cards(a: dict, mesh: list, k: int) -> dict:
    """B4 over the cards of ``mesh`` from the entry state at K = 1 and at
    K = ``k`` in turns (1, k, k, 1), each K = ``k`` solve field for field
    the K = 1 solve's: each card's kernel time (CUDA events) at both, and
    at ``k`` the rounds and the speculated and committed placing
    iterations. Comparison launches."""
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver

    out = {"k": k, "runs": []}
    want = None
    for kk in (1, k, k, 1):
        solver = ShardedBlockSolver(a, mesh, True, True, exchange_batch=kk)
        got = solver.solve()
        if want is None:
            want = got
        else:
            same_state(f"B4 at K={kk} over {len(set(map(str, mesh)))} cards against K=1", want, got)
        out["runs"].append({"k": kk, **{f"cuda:{i}": ms for i, ms in sorted(solver._mesh.device_ms.items())}})
        if kk == k:
            counts, speculated, batched = dict(solver.counts), solver._mesh.speculated_by_card, solver.batched_iters
    out.update(device_ms_by_card={c: v for c, v in out["runs"][2].items() if c != "k"},
               k1_device_ms_by_card={c: v for c, v in out["runs"][3].items() if c != "k"},
               **counts, speculated_by_card=speculated, batched_iters=batched,
               equal_to_k1=True)
    return out


def b4_floor_and_probes(m: int) -> tuple[dict, list[dict]]:
    """B1's record on ``preempt_mix(2000, 40, seed=1)`` (its raw time an
    iteration, B4's floor) and the exchange probes over the first 2 and
    ``m`` cards, then a round at BATCHED_K over ``m`` (each emitted)."""
    from kube_batch_tpu_torch import models

    floor = kernel_vs_plain("preempt_mix_2k_40_seed1", encoded_arrays(models.preempt_mix(2000, 40, seed=1)),
                            timed_runs=4, raw_runs=4)
    probes = [mesh_floor_probe(n) for n in sorted({2, m})] + [mesh_floor_probe(m, k=BATCHED_K)]
    for rec in probes:
        emit(rec)
    return floor, probes


def b4_batched_phase(encoded: dict, mesh: list, want, floor: dict, round_us: float, with_prefix: bool = True) -> dict:
    """``b4_k4_preempt_mix_50k_5k_<m>cards``: B4 over the cards of ``mesh``
    at K = 1 and BATCHED_K in turns (``b4_batched_over_cards``), the
    round's split at BATCHED_K (``b4_split``, held to ``want``, the K = 1
    solve over the cards) with its derived readings against B1's floor and
    the round probe, the latency bound and B4's share of it, then from a
    jobs prefix against its plain version and K = 1 (comparison
    launches; ``with_prefix`` false leaves that comparison out). Returns
    the record."""
    m = len(mesh)
    batched = b4_batched_over_cards(encoded, mesh, BATCHED_K)
    batched["split"] = b4_split(encoded, mesh, BATCHED_K, want, floor["raw_ms_per_iteration"], round_us)
    if with_prefix:
        batched["jobs_prefix"] = b4_vs_plain_prefix(encoded, mesh, list(range(m)), exchange_batch=BATCHED_K,
                                                    divisor=BATCHED_PREFIX)
    batched["round_us"] = round_us
    batched["rounds_per_committed"] = batched["exchange_rounds"] / max(batched["placing_iterations"], 1)
    batched["latency_bound_ms"] = (batched["iterations"] * floor["raw_ms_per_iteration"]
                                   + batched["exchange_rounds"] * round_us * 1e-3)
    batched["share_of_latency_bound"] = batched["latency_bound_ms"] / max(batched["device_ms_by_card"].values())
    return {"phase": f"b4_k{BATCHED_K}_preempt_mix_50k_5k_{m}cards", **batched}


B4_POOL_WORLD = (400_000, 40_000)  # config 7, uniform_pool: long runs of one request shape


def b4_pool_phase(mesh: list, floor: dict, round_us: float) -> dict:
    """``multichip_b4_by_k_400k_40k``: config 7 (``uniform_pool(400_000,
    40_000)``: byte-identical nodes, 1,600 gangs of 250 pods in two
    shapes, so a chain's tasks share one record key for 250 iterations),
    B4 over the cards of ``mesh`` at K = 1 and BATCHED_K in turns (1, K, K,
    1), every solve field for field B1's on cuda:0 (so K = 1's too); each
    card's kernel time, the rounds and the speculated placing iterations
    per committed one, and the round's split at BATCHED_K (``b4_split``,
    against B1's floor and the round probe). Comparison launches."""
    import torch

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver

    t0 = time.perf_counter()
    a = encoded_arrays(models.uniform_pool(*B4_POOL_WORLD))
    setup_s = time.perf_counter() - t0
    cuda0 = torch.device("cuda", 0)
    b1 = fs.FusedSolver(a, True, True, device=cuda0).solve()
    rec = {"phase": f"multichip_b4_by_k_{B4_POOL_WORLD[0] // 1000}k_{B4_POOL_WORLD[1] // 1000}k",
           "world": f"uniform_pool{B4_POOL_WORLD}", "cards": len(mesh), "setup_s": setup_s, "runs": []}
    for k in (1, BATCHED_K, BATCHED_K, 1):
        solver = ShardedBlockSolver(a, mesh, True, True, exchange_batch=k)
        same_state(f"B4 at K={k} over {len(mesh)} cards on config 7 against B1", b1, solver.solve())
        counts = dict(solver.counts)
        rec["runs"].append({"k": k, "device_ms_by_card": {f"cuda:{i}": v for i, v in sorted(solver._mesh.device_ms.items())},
                            "exchange_rounds": counts["exchange_rounds"], "iterations": counts["iterations"],
                            "placing_iterations": counts["placing_iterations"],
                            "speculated_by_card": list(solver._mesh.speculated_by_card) if k > 1 else None,
                            "rounds_per_committed": counts["exchange_rounds"] / max(counts["placing_iterations"], 1)})
    rec["split"] = b4_split(a, mesh, BATCHED_K, b1, floor["raw_ms_per_iteration"], round_us)
    rec["equal_to_b1"] = rec["k1_equal_to_k4"] = True
    return rec


def b4_only(card: str, kind: str, over_cards: bool) -> int:
    """``--b4``: kernel B4's phases on one card alone, for work on B4: the
    build (B1, B2, B4 and the exchange probe, at once), the ``cuda`` cases
    of the two B4 test files, B1's record on ``preempt_mix(2000, 40,
    seed=1)`` (B4's floor), ``b4_by_k`` with its splits, and at 50k x 5k
    B1 and B4 (K = 1, four shards of cuda:0) timed around their raw
    launches, equal, with the split at BATCHED_K over four cards of one
    solve on cuda:0, and on config 7 the same four cards at K = 1 and (the
    split) at BATCHED_K. ``--b4 --cards`` (two or more cards): the build, the
    floor and the probes, then B4 over the cards at 50k x 5k
    (``b4_batched_phase`` without its jobs prefix), nothing on one card."""
    import torch

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc
    from kube_batch_tpu_torch.ops.kernels import init_state
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver, make_mesh

    t_start = time.perf_counter()
    m = torch.cuda.device_count()
    if over_cards and m < 2:
        raise AssertionError(f"--b4 --cards needs two or more cards, found {m}")
    logs = nvcc.build(["fused_solve", "block_step", "mesh_solve", "mesh_floor"])
    emit({"phase": "build", "s": time.perf_counter() - t_start,
          "ptxas": {name: ptxas_summary(log) for name, log in logs.items()}})
    cuda0 = torch.device("cuda", 0)
    if over_cards:
        floor, probes = b4_floor_and_probes(m)
        emit({"phase": "kernel_vs_plain", **floor})
        big = encoded_arrays(models.preempt_mix(50_000, 5_000))
        b1 = fs.FusedSolver(big, True, True, device=cuda0).solve()
        mesh = make_mesh()
        torch.cuda.set_device(0)
        emit(b4_batched_phase(big, list(mesh), b1, floor, probes[-1]["exchange_us"], with_prefix=False))
        del big, b1
        emit(b4_pool_phase(list(mesh), floor, probes[-1]["exchange_us"]))
    else:
        root = os.path.dirname(os.path.abspath(__file__))
        run = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", "-m",
                              "cuda", "tests/test_torch_mesh_solve.py", "tests/test_torch_mesh_batched.py"],
                             cwd=root, capture_output=True, text=True, timeout=600)
        tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
        emit({"phase": "card_tests", "summary": tail, "rc": run.returncode})
        if run.returncode != 0:  # reported, and the run fails at its end; the timings still run
            print(run.stdout[-6000:], run.stderr[-3000:], file=sys.stderr)
        floor = kernel_vs_plain("preempt_mix_2k_40_seed1", encoded_arrays(models.preempt_mix(2000, 40, seed=1)),
                                timed_runs=4, raw_runs=4)
        emit({"phase": "kernel_vs_plain", **floor})
        small = encoded_arrays(models.preempt_mix(2000, 40, seed=1))
        want = fs.FusedSolver(small, True, True, device=cuda0).solve()
        emit(b4_by_k(small, want, cuda0, floor))
        big = encoded_arrays(models.preempt_mix(50_000, 5_000))
        packed = fs.pack(big, True, True)
        init = fs.pack_state(packed.dims, init_state(big, True, True), big["job_queue"])
        b1_times, _ = b1_raw_times(packed.to("cuda"), init, 3)
        b1 = fs.FusedSolver(big, True, True, device=cuda0).solve()
        b4_times = []
        for _ in range(2):
            solver = ShardedBlockSolver(big, [cuda0] * 4, True, True)
            same_state("B4 on one card at 50k x 5k against B1", b1, solver.solve())
            b4_times.append(solver._mesh.device_ms[0])
        probe = mesh_floor_probe(4, k=BATCHED_K, on_one_device=True)
        emit({"phase": "b4_preempt_mix_50k_5k", "b1_raw_ms": b1_times, "b4_one_card_ms": b4_times,
              "split_four_cards_on_one_device": b4_split(big, [cuda0] * 4, BATCHED_K, b1,
                                                         floor["raw_ms_per_iteration"], probe["exchange_us"]),
              "round_probe_on_one_device": probe})
        del big, b1
        # config 7 over four cards of one solve on cuda:0, K = 1 against
        # BATCHED_K, with the split (a stream a card)
        pool = encoded_arrays(models.uniform_pool(*B4_POOL_WORLD))
        b1 = fs.FusedSolver(pool, True, True, device=cuda0).solve()
        k1_state, k1_times, _, _, _ = b4_cards(pool, [cuda0] * 4, 1)
        same_state("config 7, four cards on cuda:0 at K=1, against B1", b1, k1_state)
        emit({"phase": "b4_pool_four_cards_on_one_device", "k1_ms_by_card": k1_times,
              "split": b4_split(pool, [cuda0] * 4, BATCHED_K, b1, floor["raw_ms_per_iteration"],
                                probe["exchange_us"])})
        if run.returncode != 0:
            return 1
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": m if over_cards else 1}})
    return 0


def distinct_cards(card: str) -> int:
    """The sharded rung over every visible card, one shard each, then the
    multi-card deployment's phases (see the module docstring)."""
    import torch

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.ops import nvcc
    from kube_batch_tpu_torch.parallel import make_mesh
    from kube_batch_tpu_torch.solve import allocate

    t_start = time.perf_counter()
    m = torch.cuda.device_count()
    if m < 2:
        raise AssertionError(f"--cards needs two or more cards, found {m}")
    logs = nvcc.build(["fused_solve", "block_step", "class_step", "mesh_solve", "mesh_floor"])
    emit({"phase": "build", "s": time.perf_counter() - t_start,
          "ptxas": {name: ptxas_summary(log) for name, log in logs.items()}})
    emit(native_build())
    cluster = models.preempt_mix(50_000, 5_000)
    fused = allocate(cluster, device="cuda:0")
    last = torch.device("cuda", m - 1)
    on_last = allocate(cluster, device=last)
    if (on_last.binds, on_last.pipelined) != (fused.binds, fused.pipelined):
        raise AssertionError(f"the fused rung on {last} differs from cuda:0's")
    same_state(f"fused on {last}", fused.state, on_last.state)
    mesh = make_mesh()
    if len(set(mesh)) != m:
        raise AssertionError(f"make_mesh() gave {mesh}, not {m} distinct cards")
    torch.cuda.set_device(0)
    torch.cuda.synchronize()
    fs.fused_solve.launches = bs.block_step.launches = ms.mesh_solve.launches = 0
    ms.mesh_solve.launches_by_card.clear()
    ms.mesh_solve.device_ms_by_card.clear()
    t0 = time.perf_counter()
    res = allocate(cluster, mesh=mesh)
    for d in mesh:
        torch.cuda.synchronize(d)
    total_s = time.perf_counter() - t0
    launches, stray = ms.mesh_solve.launches, (fs.fused_solve.launches, bs.block_step.launches)
    placing = int((res.state.ptr.numpy() - res.encoded.arrays["job_start"]).sum())
    by = by_card(ms.mesh_solve.launches_by_card)
    if stray != (0, 0) or by != {f"cuda:{i}": 1 for i in range(m)}:
        raise AssertionError(f"B4 by card {by}, B1 and B2 {stray}; expected one B4 launch a card and no other")
    if (res.binds, res.pipelined) != (fused.binds, fused.pipelined):
        raise AssertionError("the sharded rung over distinct cards differs from the fused rung's binds")
    same_state(f"mesh over {m} cards", fused.state, res.state)
    device_ms = by_card(ms.mesh_solve.device_ms_by_card)
    # B4 over the cards against its plain version on as many CPU cards, at
    # full width over a prefix of the work (comparison launches)
    encoded = encoded_arrays(cluster)
    prefix = b4_vs_plain_prefix(encoded, list(mesh), list(range(m)))
    del cluster, fused, on_last
    # B4's bound over the cards: B1's time per iteration on a 128-node world
    # and the exchange's latency from the probe, both measured here
    floor, probes = b4_floor_and_probes(m)
    exchange_us = probes[-2]["exchange_us"]
    iterations = int(res.state.it)
    latency_ms = iterations * floor["raw_ms_per_iteration"] + placing * exchange_us * 1e-3
    emit(b4_batched_phase(encoded, list(mesh), res.state, floor, probes[-1]["exchange_us"]))
    del encoded
    emit(b4_pool_phase(list(mesh), floor, probes[-1]["exchange_us"]))
    emit({
        "phase": f"allocate_mesh_preempt_mix_50k_5k_{m}cards", "mesh": [str(d) for d in mesh],
        "total_s": total_s, **res.timings, "iterations": iterations, "placing_iterations": placing,
        "b4_launches": launches, "b4_launches_by_card": by, "b4_device_ms_by_card": device_ms,
        "floor_ms_per_iteration": floor["raw_ms_per_iteration"], "exchange_us": exchange_us,
        "latency_bound_ms": latency_ms, "share_of_latency_bound": latency_ms / max(device_ms.values()),
        "binds": len(res.binds), "equal_to_fused": True, "jobs_prefix": prefix, **check_binds(res),
    })
    del res
    failures = multichip_phases(card=card_line(every=True))
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    if failures:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failures), file=sys.stderr, flush=True)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": m}})
    return 0


def upload_probe(card: str, kind: str) -> int:
    """``--uploads``: the host time of one upload to the card, by route, at
    the class rung's shapes: ``class_members`` (int32 over config 7's
    40,064 nodes) and a task table of config 7's size (float32, 409,600 x
    4). Each route is timed with the card idle and with the card busy
    (about 0.75 ms of queued work before each upload, as B3's segments can
    leave it). Routes: the parent's ``.to(card)`` (waits for the stream),
    ``.to(card, non_blocking=True)`` from pageable memory, a pinned
    staging copy, and the tensor arena's upload by its own route
    (``port``: pageable when the card is idle, else pinned), through
    pinned staging only and through a pageable copy only:
    a miss (new content of the same shape) and a reuse (equal content in
    another array). Prints one record a slab."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.ops import encode_cache

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    reps = 200
    port_to, pinned_to = encode_cache._to, encode_cache._staged_to

    def pageable_to(src, device):
        return src.to(device, non_blocking=True)

    def timed(fn, inputs) -> dict:
        rec = {}
        for load in ("idle", "busy"):
            out = []
            for x in inputs:
                if load == "busy":
                    torch.cuda._sleep(1_500_000)
                else:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x)
                out.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            out.sort()
            rec[load] = {"p50_us": out[len(out) // 2], "p90_us": out[int(len(out) * 0.9)],
                         "mean_us": sum(out) / len(out)}
        return rec

    slabs = {
        "class_members": lambda: rng.permutation(40_064).astype(np.int32),
        "class_task_table": lambda: rng.random((409_600, 4), dtype=np.float32),
    }
    for name, make in slabs.items():
        fresh = [make() for _ in range(8)]
        inputs = [fresh[i % len(fresh)] for i in range(reps)]
        equal = [fresh[0].copy() for _ in range(8)]
        rec = {"phase": "upload_probe", "slab": name, "bytes": int(fresh[0].nbytes), "reps": reps}
        rec["to_sync"] = timed(lambda x: torch.from_numpy(x).to(dev), inputs)
        rec["to_pageable_non_blocking"] = timed(lambda x: torch.from_numpy(x).to(dev, non_blocking=True), inputs)
        rec["pinned_stage"] = timed(lambda x: pinned_to(torch.from_numpy(x), dev), inputs)
        for route, to in (("port", port_to), ("pinned", pinned_to), ("pageable", pageable_to)):
            encode_cache._to = to
            try:
                arena = encode_cache.TensorArena(dev)
                rec[f"arena_miss_{route}"] = timed(lambda x: arena.upload(name, x), inputs)
                arena.upload(name, fresh[0])
                rec[f"arena_reuse_{route}"] = timed(lambda x: arena.upload(name, x), [equal[i % 8] for i in range(reps)])
                if arena.full_uploads != 2 * reps + 1 or arena.reuses != 2 * reps:
                    raise AssertionError(f"upload_probe: {arena.counters()}")
            finally:
                encode_cache._to = port_to
        emit(rec)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


def main(argv: list[str]) -> int:
    import torch

    if argv[:1] == ["--rehearse"]:
        return rehearse(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if argv in (["--cards"], ["--pipeline-uncut"], ["--federation"], ["--streaming"], ["--operator"],
                ["--classes"], ["--uploads"], ["--b4"], ["--b4", "--cards"]) or (
            argv[:1] in (["--ab-warm"], ["--ab-b4"]) and len(argv) == 2):
        card = card_line()
        emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})
        if argv == ["--cards"]:
            return distinct_cards(card)
        if argv[0] == "--b4":
            return b4_only(card, torch.cuda.get_device_name(0), argv[1:] == ["--cards"])
        if argv[0] == "--ab-warm":
            return ab_warm(argv[1])
        if argv[0] == "--ab-b4":
            return ab_b4(argv[1])
        if argv == ["--federation"]:
            return federation_only(card, torch.cuda.get_device_name(0))
        if argv == ["--streaming"]:
            return streaming_only(card, torch.cuda.get_device_name(0))
        if argv == ["--operator"]:
            return operator_only(card, torch.cuda.get_device_name(0))
        if argv == ["--classes"]:
            return classes_only(card, torch.cuda.get_device_name(0))
        if argv == ["--uploads"]:
            return upload_probe(card, torch.cuda.get_device_name(0))
        return pipeline_uncut(card, torch.cuda.get_device_name(0))
    if argv:
        print(f"chip_smoke: unknown arguments {argv}; usage: chip_smoke.py [--cards | --pipeline-uncut | "
              "--federation | --streaming | --operator | --classes | --uploads | --b4 [--cards] | --ab-warm DIR | "
              "--ab-b4 DIR | "
              "--rehearse CUT [--cards]]", file=sys.stderr)
        return 2
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.analysis.trace import guard_calls
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import class_solve as cs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import mesh_solve as ms
    from kube_batch_tpu_torch.ops import nvcc
    from kube_batch_tpu_torch.ops.kernels import init_state
    from kube_batch_tpu_torch.parallel import make_mesh
    from kube_batch_tpu_torch.solve import allocate

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    native_rec: dict = {}

    def build_native():
        try:
            native_rec.update(native_build())
        except Exception as e:  # noqa: BLE001 - raised below, after the kernels' build
            native_rec["error"] = e

    native_thread = threading.Thread(target=build_native)
    native_thread.start()  # g++ beside the nvcc processes
    logs = nvcc.build(["fused_solve", "block_step", "class_step", "class_floor", "mesh_solve", "mesh_floor"])
    fs._library.load()
    bs._library.load()
    cs._library.load()
    ms._library.load()
    native_thread.join()
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "ptxas": {name: ptxas_summary(log) for name, log in logs.items()}})
    if "error" in native_rec:
        raise RuntimeError(f"native_build: the native hot loops cannot be built or loaded: {native_rec['error']}")
    emit(native_rec)
    emit(card_tests())

    # -- B1 against its plain version ----------------------------------------
    worlds = [
        ("synthetic_1k_100", lambda: models.synthetic(1000, 100)),
        ("multi_queue_10k_1k", lambda: models.multi_queue(10_000, 1000)),
        ("multi_tenant_ml_200_500", lambda: models.multi_tenant_ml(200, 500)),
    ]
    for name, make in worlds:
        rec = kernel_vs_plain(name, encoded_arrays(make()))
        emit({"phase": "kernel_vs_plain", **rec})
    # the per-iteration floor: a world whose node axis fits one node per
    # thread, so an iteration is the barriers and the dependent loads alone
    floor = kernel_vs_plain("preempt_mix_2k_40_seed1", encoded_arrays(models.preempt_mix(2000, 40, seed=1)),
                            timed_runs=4, raw_runs=4)
    floor_ms_per_iter = floor["ms_per_iteration"]
    emit({"phase": "kernel_vs_plain", **floor})

    main_worlds = [
        ("preempt_mix_50k_5k", lambda: models.preempt_mix(50_000, 5_000)),
        ("preempt_mix_50k_1k", lambda: models.preempt_mix(50_000, 1_000)),
    ]
    clusters, generate_s = {}, {}
    for name, make in main_worlds:
        t0 = time.perf_counter()
        clusters[name] = make()
        generate_s[name] = time.perf_counter() - t0
    arrays = {name: encoded_arrays(clusters[name]) for name, _ in main_worlds}

    b1_head = kernel_vs_plain("preempt_mix_50k_1k", arrays["preempt_mix_50k_1k"], timed_runs=4)
    b1_head["latency_bound_ms"] = b1_head["iterations"] * floor_ms_per_iter
    emit({"phase": "kernel_vs_plain", **b1_head})
    # B1 at the headline's full width, over a prefix of its work: only the
    # first sixteenth of the job rows active (the whole solve's plain run
    # takes minutes of host CPU)
    prefix = jobs_prefix(arrays["preempt_mix_50k_5k"])
    emit({"phase": "kernel_vs_plain", "jobs_active": int(prefix.job_active.sum()),
          **kernel_vs_plain("preempt_mix_50k_5k_jobs_prefix", arrays["preempt_mix_50k_5k"], state=prefix)})

    # -- B2 against its plain version ----------------------------------------
    b2 = b2_comparisons(arrays["preempt_mix_50k_5k"], arrays["preempt_mix_50k_1k"],
                        encoded_arrays(models.multi_tenant_ml(200, 500)))
    b2_timed = {r["N"]: r for r in b2 if "step" in r}
    emit({"phase": "block_vs_plain", "inputs": len(b2), "bit_equal": True})
    b2_head = b2_timed[max(b2_timed)]

    # -- the fused rung's main path, through the entry point -----------------
    results, phases = {}, []
    torch.cuda.synchronize()
    fs.fused_solve.launches = bs.block_step.launches = 0
    for name, _ in main_worlds:
        before = fs.fused_solve.launches
        t0 = time.perf_counter()
        results[name] = allocate(clusters[name], device="cuda")
        torch.cuda.synchronize()
        phases.append((name, time.perf_counter() - t0, fs.fused_solve.launches - before))
    b1_launches, stray = fs.fused_solve.launches, bs.block_step.launches
    if stray:
        raise AssertionError(f"the fused rung launched the block step {stray} times")
    for name, total_s, n_launch in phases:
        if n_launch < 1:
            raise AssertionError(f"allocate on {name} did not launch the fused-solve kernel")
        res = results[name]
        emit({
            "phase": f"allocate_{name}", "generate_s": generate_s[name], "total_s": total_s,
            **res.timings, "binds": len(res.binds), "pipelined": len(res.pipelined),
            "tasks": res.encoded.n_tasks, "nodes": res.encoded.n_nodes, "launches": n_launch,
            **check_binds(res),
        })
    if not results["preempt_mix_50k_1k"].pipelined:
        raise AssertionError("preempt_mix_50k_1k pipelined nothing: the releasing branch did not run")
    for name, _ in main_worlds:
        DRIFT[f"fused_{name}"] = (results[name].state, arrays[name])
    b1_ms_5k, b1_iters_5k = [], 0
    for _ in range(2):  # B1 at the headline, kernel only (its plain run is the sharded path's job)
        packed = fs.pack(arrays["preempt_mix_50k_5k"], True, True)
        init = fs.pack_state(packed.dims, init_state(arrays["preempt_mix_50k_5k"], True, True),
                             arrays["preempt_mix_50k_5k"]["job_queue"])
        dev, st = packed.to("cuda"), fs.PackedState(packed.dims, init.istate.cuda(), init.fstate.cuda())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fs.fused_solve(dev, st)
        end.record()
        torch.cuda.synchronize()
        b1_ms_5k.append(start.elapsed_time(end))
        b1_iters_5k = int(st.istate[0])
    fs.fused_solve.launches = b1_launches  # timing launches are not the main path's
    geo_5k = fs.solve_geometry(packed.dims)
    b1_5k = {"ms": b1_ms_5k[-1], "iterations": b1_iters_5k, "ms_per_iteration": b1_ms_5k[-1] / b1_iters_5k,
             "latency_bound_ms": b1_iters_5k * floor_ms_per_iter, "k": geo_5k.shape.k,
             "smem_bytes": geo_5k.smem_bytes}
    emit({"phase": "fused_solve_50k_5k", "runs_ms": b1_ms_5k, **b1_5k})

    # -- the sharded rung's main path: kernel B4 ------------------------------
    cuda0 = torch.device("cuda", 0)
    mesh_launches = {}
    for name, m in (("preempt_mix_50k_5k", 1), ("preempt_mix_50k_5k", 4), ("preempt_mix_50k_1k", 4)):
        torch.cuda.synchronize()
        fs.fused_solve.launches = bs.block_step.launches = ms.mesh_solve.launches = 0
        ms.mesh_solve.device_ms_by_card.clear()
        t0 = time.perf_counter()
        with guard_calls(ms, "_launch_cards") as guarded:  # each B4 launch group under "error"
            res = allocate(clusters[name], device="cuda", mesh=make_mesh(devices=[cuda0] * m))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches, stray = ms.mesh_solve.launches, (fs.fused_solve.launches, bs.block_step.launches)
        if guarded["calls"] != launches:
            raise AssertionError(f"{name} m={m}: {guarded['calls']} guarded B4 launch groups for {launches} launches")
        DRIFT[f"sharded@{m}_{name}"] = (res.state, arrays[name])
        placing = int((res.state.ptr - arrays[name]["job_start"]).sum())
        if stray != (0, 0):
            raise AssertionError(f"the sharded rung launched B1 and B2 {stray} times")
        if launches != 1:
            raise AssertionError(f"{name} m={m}: {launches} B4 launches, expected one (one card, one segment)")
        fused = results[name]
        if (res.binds, res.pipelined) != (fused.binds, fused.pipelined):
            raise AssertionError(f"{name} m={m}: binds or pipelined tasks differ from the fused rung's")
        same_state(f"{name} m={m}", fused.state, res.state)
        mesh_launches[(name, m)] = launches
        B4_PATHS[f"allocate_mesh_{name}_m{m}"] = launches
        emit({
            "phase": f"allocate_mesh_{name}_m{m}", "total_s": total_s, **res.timings,
            "iterations": int(res.state.it), "placing_iterations": placing, "b4_launches": launches,
            "b4_device_ms_by_card": by_card(ms.mesh_solve.device_ms_by_card),
            "launches_without_sync": guarded["calls"], "binds": len(res.binds), "pipelined": len(res.pipelined),
            "equal_to_fused": True, **check_binds(res),
        })

    # -- the K-deep batched exchange, beside the per-iteration exchange, -----
    # -- K = 1 through the JAX GSPMD rung's surface -------------------------
    small = encoded_arrays(models.preempt_mix(2000, 40, seed=1))
    want = fs.FusedSolver(small, True, True, device=cuda0).solve()
    exchange_recs, surface_launches, b2_launches = exchange_phase(small, want, floor=floor)
    for rec in exchange_recs:
        emit(rec)
    b4_k = next(r for r in exchange_recs if r["phase"] == "b4_by_k")
    B4_PATHS["sharded_surface_and_exchange_k4"] = surface_launches  # b2_launches: the host loop's own path

    # -- B4 against the host loop over B2, B1 and its plain version ----------
    saved = ms.mesh_solve.launches, bs.block_step.launches
    b4 = mesh_solve_vs_plain(small, arrays["preempt_mix_50k_5k"], floor)
    ms.mesh_solve.launches, bs.block_step.launches = saved  # comparison launches are not the main path's
    emit(b4)

    # -- the scheduling cycle: session, plugins, torch_allocate, replay ----
    failures, cycle_launches = cycle_phases(clusters, results, mesh_launches)
    # -- the twin pipeline: enqueue, reclaim, allocate, backfill, preempt ---
    pipeline_failures, pipeline_launches = pipeline_phases(clusters, results)
    failures += pipeline_failures
    # -- the host fast paths: encode cache, warm cycles, native parity ------
    fast_failures, fast_launches = fast_path_phases(clusters, results)
    failures += fast_failures + degradation_failures()
    # -- the solver ladder under faults, the cycle under trace --------------
    ladder_failures, ladder_launches = ladder_trace_phases(clusters, results)
    failures += ladder_failures
    # -- the port as a process: store, cache, loop and HTTP -----------------
    clusters.clear()  # free the main worlds: the process phases generate their own
    shared: dict = {}
    server_failures, server_launches = server_phases(cut=PROCESS_CUT, shared=shared)
    failures += server_failures
    # -- the port as a federation: shard processes and threads over one store
    fed_failures, fed_launches = federation_phases(cut=PROCESS_CUT, shared=shared)
    failures += fed_failures
    shared.clear()
    # -- the streaming scheduler: streamed bursts, pipelined cycles, drills -
    stream_failures, stream_launches = streaming_phases()
    failures += stream_failures
    # -- the operator surfaces: explain, the fleet rollup, admission --------
    operator_failures, operator_launches = operator_phases()
    failures += operator_failures
    # -- the class-compressed solve: config 7, preempt_mix, B3, drills ------
    class_failures, class_launches, b3 = class_phases()
    failures += class_failures
    # -- the port's analyzers on the card: drift across rungs, interleavings -
    analyzer_failures, analyzer_launches = analyzer_phases()
    failures += analyzer_failures
    if failures:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failures), file=sys.stderr, flush=True)
        return 1
    cycle_launches.update(pipeline_launches)
    cycle_launches.update(fast_launches)
    cycle_launches.update(ladder_launches)
    cycle_launches.update(server_launches)
    cycle_launches.update(fed_launches)
    cycle_launches.update(stream_launches)
    cycle_launches.update(operator_launches)
    cycle_launches.update({k: v[:2] for k, v in class_launches.items()})
    cycle_launches.update(analyzer_launches)
    b3_by_path = {k: v[2] for k, v in class_launches.items() if v[2]}
    if b3_by_path.get("classes_400k_40k", 0) < 1:
        raise AssertionError("the class-compressed main path launched B3 no time")
    b3_head = b3[0]
    b3_ptxas = {r["function"]: r for r in ptxas_summary(logs.get("class_step", ""))}
    b1_by_path = {"allocate_fused": b1_launches, **{k: v[0] for k, v in cycle_launches.items() if v[0]}}
    b2_by_path = {"host_loop_k4": b2_launches, **{k: v[1] for k, v in cycle_launches.items() if v[1]}}
    b4_head = b4["preempt_mix_2k_40_seed1"]
    b4_5k = b4["preempt_mix_50k_5k"]
    if sum(B4_PATHS.get(f"allocate_mesh_preempt_mix_{w}_m{m}", 0) for w, m in (("50k_5k", 1), ("50k_5k", 4),
                                                                              ("50k_1k", 4))) != 3:
        raise AssertionError(f"the sharded main path launched B4 {B4_PATHS}")

    for rec in b2_timed.values():  # B2's device time, with the profiler, last
        time_b2_kernel(rec)
        emit({"phase": "block_step_timed", **rec})

    emit({"kernels": [
        {
            "name": "fused_solve",
            "route": "cuda",
            "source": "kube_batch_tpu_torch/csrc/fused_solve.cu",
            "replaces": "kube_batch_tpu/ops/pallas_solve.py:442",
            "launches": sum(b1_by_path.values()),
            "launches_by_path": b1_by_path,
            "max_abs_err": b1_head["max_abs_err"],
            "ms": b1_head["ms"],
            "plain_ms": b1_head["plain_ms"],
            "bound_ms": b1_head["bound_ms"],
            "bound_by": b1_head["bound_by"],
            "library_ms": None,
            "world": "preempt_mix_50k_1k",
            "k": b1_head["k"],
            "ms_per_iteration": b1_head["ms_per_iteration"],
            "latency_bound_ms": b1_head["latency_bound_ms"],
            "floor_ms_per_iteration": floor_ms_per_iter,
            "ms_preempt_mix_50k_5k": b1_5k["ms"],
            "ms_per_iteration_preempt_mix_50k_5k": b1_5k["ms_per_iteration"],
            "latency_bound_ms_preempt_mix_50k_5k": b1_5k["latency_bound_ms"],
            "k_preempt_mix_50k_5k": b1_5k["k"],
        },
        {
            "name": "block_step",
            "route": "cuda",
            "source": "kube_batch_tpu_torch/csrc/block_step.cu",
            "replaces": "kube_batch_tpu/ops/pallas_solve.py:914",
            "launches": sum(b2_by_path.values()),
            "launches_by_path": b2_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in b2),
            "ms": b2_head["ms"],
            "plain_ms": b2_head["plain_ms"],
            "bound_ms": b2_head["bound_ms"],
            "bound_by": b2_head["bound_by"],
            "library_ms": None,
            "world": "preempt_mix_50k_5k, one 5,120-node block, entry state",
            "k": b2_head["k"],
            "device_ms": b2_head["device_ms"],
            "widths": [
                {key: r[key] for key in ("N", "k", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bytes")}
                for _, r in sorted(b2_timed.items(), reverse=True)
            ],
        },
        {
            "name": "class_step",
            "route": "cuda",
            "source": "kube_batch_tpu_torch/csrc/class_step.cu",
            "replaces": "kube_batch_tpu/ops/class_solve.py:326",
            "launches": sum(b3_by_path.values()),
            "launches_by_path": b3_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in b3),
            "ms": b3_head["device_ms"],
            "plain_ms": b3_head["plain_ms"],
            "bound_ms": b3_head["bound_ms"],
            "bound_by": b3_head["bound_by"],
            "library_ms": None,
            "world": b3_head["world"] + ", one segment from the entry state",
            "device_ms": b3_head["device_ms"],
            "wrapper_ms": b3_head["wrapper_ms"],
            "profiler_device_ms": b3_head.get("profiler_device_ms"),
            "c_pad": b3_head["c_pad"],
            "threads": b3_head["threads"],
            "in_smem": b3_head["in_smem"],
            "working_bytes": b3_head["working_bytes"],
            "iterations": b3_head["iterations"],
            "ms_per_iteration": b3_head["ms_per_iteration"],
            "latency_bound_ms": b3_head["latency_bound_ms"],
            "latency_bound_by": "csrc/class_floor.cu at the segment's slots, threads and iterations",
            "share_of_latency_bound": b3_head["latency_bound_ms"] / b3_head["device_ms"],
            "ptxas": list(b3_ptxas.values()),
            "slope_ms_per_iteration": B3_FLOOR["ms_per_iteration"],
            "slope_fixed_ms": B3_FLOOR["fixed_ms"],
            "slope_host_fixed_ms": B3_FLOOR["host_fixed_ms"],
            "slope_world": B3_FLOOR["world"],
            "slope_c_pad": B3_FLOOR["c_pad"],
            "inputs": [
                {key: r[key] for key in (
                    "world", "c_pad", "threads", "in_smem", "iterations", "device_ms", "wrapper_ms", "plain_ms",
                    "bound_ms", "bytes",
                    "overflow")}
                for r in b3
            ],
        },
        {
            "name": "mesh_solve",
            "route": "cuda",
            "source": "kube_batch_tpu_torch/csrc/mesh_solve.cu",
            "replaces": "kube_batch_tpu/parallel/sharded_pallas.py:267",
            "launches": sum(B4_PATHS.values()),
            "launches_by_path": dict(B4_PATHS),
            "max_abs_err": b4_head["max_abs_err"],
            "ms": b4_head["ms"],
            "plain_ms": b4_head["plain_ms"],
            "bound_ms": b4_head["bound_ms"],
            "bound_by": b4_head["bound_by"],
            "library_ms": None,
            "world": "preempt_mix_2k_40_seed1, four shards on cuda:0 (one card, one launch), entry state",
            "k": b4_head["k"],
            "ms_per_iteration": b4_head["ms_per_iteration"],
            "latency_bound_ms": b4_head["latency_bound_ms"],
            "latency_bound_by": "iterations x B1's time per iteration on the same 128-node world, CUDA events "
                                "around its launch alone as B4's (one card: no exchange; --cards adds "
                                "csrc/mesh_floor.cu's exchange latency)",
            "plain_jobs_prefix_preempt_mix_50k_5k": b4_5k["jobs_prefix"],
            "ms_preempt_mix_50k_5k": b4_5k["ms"],
            "ms_per_iteration_preempt_mix_50k_5k": b4_5k["ms_per_iteration"],
            "k_preempt_mix_50k_5k": b4_5k["k"],
            "host_loop_s_preempt_mix_50k_5k": b4_5k["host_loop_s"],
            "by_k_one_card_m4": b4_k["one_card_m4"],
            "by_k_four_cards_on_one_device": b4_k["four_cards_on_one_device"],
            "ptxas": ptxas_summary(logs.get("mesh_solve", "")),
        },
    ]})
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})  # the one card driven
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
