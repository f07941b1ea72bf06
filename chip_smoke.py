#!/usr/bin/env python3
"""Drive pinot_tpu_torch on one CUDA card: build, kernel checks, SSB
Q1.1-Q4.3 in memory, baseballStats from disk under the QueryGenerator
mix with its selections, and VECTOR_SIMILARITY over the 10M x 128 vector
table with IVF codebooks, each table per segment, stacked (one launch
per kernel over all segments) and in cross-query batches (one launch per
kernel for up to 8 queries); then the upsert table
baseballStats_REALTIME, ingested, served while it consumes (frozen
prefix on the card, tail on the host) and masked by validDocIds; and the
multi-stage plane: joins of lineorderj x part and window functions, stage
1 -> exchange -> stage 2; the JAX bench's SSB path: SSB segments built on
disk with the nine star-tree cubes, and a 100M-row SSB stack synthesized
on the card by K17 ssb_synth; and the query server: ServerInstances on
the card answering 16 concurrent TCP clients over the SSB table
(coalesced batches, the result cache, residency tiers under a byte
budget), raw-key join members in one batched K1, and a stage-2 server
fetching a peer's stage-1 block over TCP.

    python3 chip_smoke.py [--sf 10] [--segments 8] [--repeats 5] [--seed 0]
                          [--bb-rows 10000000] [--bb-segments 4]
                          [--vec-rows 10000000] [--vec-segments 4]
                          [--vec-dim 128] [--vec-queries 5]
                          [--batch-repeats 3]
                          [--rt-rows 5000000] [--rt-sealed 1]
                          [--rt-repeats 3]
                          [--join-rows 60000000] [--join-segments 8]
                          [--join-dim-rows 800000]
                          [--store-sf 1] [--synth-rows 100000000]

Phases, each printed as one JSON line; any failure ends the run with a
non-zero exit and no result line:

1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: nvcc builds the kernels from ops/csrc/ (one process per source,
   all at once) into build/pinot_tpu_torch/<hash>/; the line also says
   whether g++ built the host cube loops (native/seglib.cpp, whose numpy
   fallbacks serve otherwise).
3. data: the SSB lineorder table at scale factor --sf (6,000,000 rows per
   scale factor) in --segments segments, made from --seed.
4. kernel check: K1-K3 against their plain PyTorch versions on the card,
   on the lanes and parameters the SSB plans give them on segment 0
   (integer outputs equal, float64 sums within CSUMS_RTOL), timed with
   CUDA events and an L2 flush before each launch, beside their bounds.
   K3 runs on every group-by query (planned with compaction off: its
   dense direct-keyed route), and where its table fits a block's
   shared memory, also with the shared tables forced on and forced off.
   K1's vdoc node: Q1.1 ANDed with a liveness lane (a third of the rows
   superseded), bit-equal in both instantiations, timed beside the same
   K1 without the node and the general instantiation.
5. ssb: launch counts set to 0, the 13 queries run once through
   QueryEngine on the card and are checked against the numpy oracle, the
   counts read (K1-K3 must have launched); then --repeats timed runs per
   query give the p50. A filtered group-by takes the planner's default,
   the adaptive compacted route (phase 11b).
6. bb_data: the baseballStats table (Apache Pinot's quickstart schema),
   --bb-rows rows in --bb-segments segments, each written by the port's
   SegmentCreator from its own seed into a directory under build/, the
   raw-key table (baseball.RAW_KEY_ROWS rows in one segment, runs, hits
   and salary without a dictionary) and the MV metric table
   (baseball.MV_METRIC_ROWS rows in one segment, a multi-value INT
   column), then loaded with QueryEngine.from_dirs on the card.
7. bb_kernel_check: K1 (raw and MV programs), K2 (runs and hits part
   lanes), K3 (sums and min / max; MV keys over position alone, position
   x league and valuein(position, ...) x league with count, SUM(hits)
   and MIN(runs); raw keys on the raw-key segment), K4 (ids, and MV
   entries of position), K5 (ids, raw, and MV entries of position and of
   an int16 MV lane built for the check) and K7 (HLL registers of
   playerName and teamID) against their plain versions on segment 0's
   lanes (min / max, counts, part sums, histograms and registers equal;
   float64 sums within CSUMS_RTOL), timed beside their bounds and, where
   one PyTorch call does the same, that call (torch.bincount for K4,
   scatter_reduce amax for K7); K3 as in phase 4.
8. select_kernel_check: K6 against its plain version on segment 0's lanes
   for each select kind (limit; order on runs, hits and on the heavily
   tied league; ordertk on salary; ordermk on teamID, salary and on int64
   / float64 lanes built for the check), at k = 16, 2048 and 65,536, under
   the masks yearID >= 2000, match-all and empty: docids, count and every
   gathered column bit-equal; timed beside its bound, the plain version
   and, where one PyTorch call does the same (torch.nonzero for limit,
   torch.topk on the masked int64 key (word, docid) for one key word),
   that call.
9. baseball: launch and path counts set to 0, the aggregation, group-by,
   HAVING, selection, two-key ORDER BY and MV group-by draws of the
   QueryGenerator mix (the reference seeds), the fixed queries and
   selections, one query per device shape (HLL, MV and expression
   aggregations, expression, MV and valuein keys), the raw-key table's
   group-bys and the MV metric table's queries (MINMV ... PERCENTILE50MV,
   COUNTMV, DISTINCTCOUNTMV, GROUP BY a numeric MV column) run once and
   are checked against the vectorised oracles; the host twin must have answered exactly the draws the JAX
   planner refuses (the 5 group-by DISTINCTCOUNT draws and
   COUNTMV(valuein(...))), and the pruner and a fast path must have
   served segments; the launch counts read (all seven kernels must have
   launched); then --repeats timed runs per device-answered query give
   the per-family p50 (the host-answered draws are timed by their one
   checked run: numpy takes seconds on them).
10. stacked_kernel_check (after phase 5, on the SSB segments stacked
   by parallel.ShardedQueryExecutor): the stacked K1 (mask and
   per-segment matches, Q1.1), K2 (one exact row per segment), K3 (int64
   part sums and csums over the whole stack, Q2.1, Q3.2, Q4.3), K6 (a top
   k per segment, two selections over lineorder) and K4, K5 and K7 over
   the stack's flat rows, each against its plain stacked version and
   against S per-segment launches on the same lanes; timed as one stacked
   launch, as S sequential launches and beside the stacked bound; K1's
   vdoc node over an [S, P] liveness lane the same way.
11. ssb_stacked: the 13 queries through QueryEngine(segments,
   mesh=make_mesh()): each must take the stacked route, launch each
   kernel it uses once (counts set to 0 before each query, read after),
   and give the numpy oracle's rows and the sequential port's; then the
   timed repeats, p50 beside phase 5's.
11b. group_compact (after 11; the adaptive compacted group-by, the
   planner's default): on segment 0, the final dispatch of SSB Q2.1
   (idoff keys, dense compacted tables) and Q3.1 (idrank keys, the dense
   regime) as the executor drives them; K3 over the remapped keys, K14
   block_compact and K15 slot_tables against their plain versions
   (integers equal, float64 sums within CSUMS_RTOL), timed with the L2
   flushed beside their bounds and torch.nonzero + index_select (K14),
   index_add_ (K15). Then SSB Q2.1-Q4.3, per segment and stacked, with
   compaction on and off (a second engine whose executor is
   ServerQueryExecutor(InstancePlanMaker(allow_group_compaction=False));
   the stacked engine's plan maker swapped, so the stack is shared):
   launch and route counts from 0, one checked run each (the oracle),
   p50 of at most 3 timed runs; and the crowded case: the first 2
   segments' rows sorted on d_yearmonthnum (a sortedColumn time
   column), a one-month filter whose rows fill whole blocks, which must
   escalate.
12. baseball_stacked: the baseballStats draws of phase 9 through a
   stacked engine over the same 4 segments (their own dictionaries,
   stacked through the union remap); counts set to 0 before, read after
   (all seven kernels must launch); each answer must equal phase 9's,
   which met the oracle (else the oracle judges it); routes counted:
   stacked, fast_path and not_shardable (NotShardable, with the reasons),
   host_twin (the planner's refusals: exactly the host-answered draws).
12b. group_compact (after 12): on baseballStats segment 0, runs x hits
   under a 0.05% filter (37,500 potential groups, the ranked layout:
   K16 rank_slots by its bitmap and by K12's sort, as radix_sort_rank,
   beside torch.unique) and playerName x runs x hits under
   numGroupsLimit 40M (the sort route) as in 11b; then every device-answered draw of phase 9 that
   groups under a WHERE and those two cases, on and off, per segment and
   stacked, checked against the oracle. The group_compact_routes line
   gives the route counts (scouts, hist rungs, idoff / idrank keys,
   dense regime, compacted, ranked, sorted rung, escalations); each route
   and each new kernel (K14, K15, K16, radix_sort_rank, K3's idoff and
   idrank keys) must have been taken.
13. vec_data: the vector table of tools/vecdata.py (the JAX package's
   scripts/vec_ann_bench.py rung: --vec-rows rows of --vec-dim dims in
   --vec-segments segments, drawn around 256 centres from seed 2016),
   sealed by the port's SegmentCreator with a 256-centroid IVF codebook
   a segment trained on the card (launch counts from 0: K10 and K11 must
   launch), loaded with from_dirs and its lanes put on the card; build,
   draw, train and load seconds, device and disk bytes.
14. vector_kernel_check: K8 (both metrics), K6's vector kind, K9, K1's
   ivf_probe node, K10 and K11 against their plain versions on segment
   0's lanes (K11 also with every row on one centroid), and K8,
   K6-vector, K9 and K1 over the stack against their plain stacked
   versions and S per-segment launches (vector_kernel_check says what
   must be equal); timed with the L2 flushed, beside their
   bounds (bytes for K8, K6 and K9, operations for K10) and the nearest
   PyTorch call (torch.mv, torch.topk, torch.topk of torch.mv, cdist with
   argmin, index_add_).
15. vector: per segment and stacked, launch counts from 0, --vec-queries
   query vectors (drawn as the script draws them) under COSINE and DOT,
   exact and at nprobe 1, 4 and 16, and one filtered exact query (WHERE
   rid < 30% of the rows), each run once: every exact answer equal to the
   chunked numpy oracle bit for bit, the stacked answers equal to the
   per-segment ones, every query on the stacked route; per rung the p50
   of --repeats timed runs, the scanned share (numDocsScanned / rows) and
   recall@10 against the exact answer; some nprobe rung under COSINE must
   reach recall@10 >= 0.95 scanning < 15% of the rows (the script's gate).
16. batch_kernel_check (after 11, 12 and 15, on segment 0 of each
   table): every batched kernel (run_segment_kernel_batched's member
   axis) at 2, 5 and 8 members: K1 over the SSB Q1.1 family, the
   baseballStats raw, MV and dictId families and the vecbench ivf_probe
   node; K2, K4 (ids and MV entries), K5 (raw with block sums, ids, MV
   entries), K6 (each kind of SELECT_PQLS) and K7 over the dictId
   family's masks; K8 (both metrics), K9 and K6's vector kind over 8
   query vectors. Each against its plain batched version (as the single
   checks hold it), bit for bit against as many single launches, and
   launched once a call; timed at 8 members with the L2 flushed beside
   8 single launches, its bound and, for K8, torch.mm. K1's vdoc node on
   the Q1.1 family over one shared liveness lane, and on a baseballStats
   filter (one member).
17. batch: ServerQueryExecutor.execute_batch over each table's segments
   (tools/ssb.py:q1_batches, tools/baseball.py:batch_draws, the 8 vector
   queries under COSINE and DOT at every rung and queries[0] at rid <
   10 / 20 / 30% of the rows), each member's block reduced by the
   engine's reducer: every member equal to its own engine.query and to
   the oracle (exact vector answers bit for bit; probed ones against
   their own queries), and, launch counts from 0, each kernel of the
   plan launched once per segment per batch of <= 8 members whose plans
   share a signature (a mixed family: group-by members, a fast path);
   then the p50 of --batch-repeats batched runs beside the sum of the
   members' sequential p50s.
17a. ssb_store (after 17 on the SSB table): stage 1 of the JAX bench
   (bench.py:932-997): the SSB table at --store-sf (6,000,000 rows per
   scale factor, bench.py's seed 3) written by the port's SegmentCreator
   into --segments directories under build/ with the nine star-tree cubes
   of tools/datagen.py:SSB_STAR_TREE_CONFIGS, loaded with
   ImmutableSegmentLoader; launch and path counts from 0, the 13 queries
   once per segment and once through a stacked engine, each checked
   against the numpy oracle, with the paths they took (a covering cube
   answers where the JAX executor takes one: the multi-segment cube, and
   the stacked plan's cube fast path sends the query per segment); the
   Q1 families of tools/ssb.py:q1_batches as execute_batch batches, each
   member against the oracle; cubes must have answered and K1, K2 and the
   batched K2 launched; then p50s of --repeats per query and path; build
   and load seconds, cube sizes, the cube path counts.
17b. ssb_synth: stage 2 of the JAX bench (bench.py:1046-1100): launch
   counts from 0, --synth-rows rows (bench.py's 100M) in --segments
   segments synthesized on the card by make_ssb_device_stack (K17
   ssb_synth, JAX's threefry lanes bit for bit, seed 3), the real rows'
   ids pulled back for the numpy oracle, the 13 queries once over the
   stack through ShardedQueryExecutor.execute_stack (the port's lane-
   override stack, tools/datagen.py:SynthStack), each checked; the counts
   read (K17 and K1-K3 must have launched). Then K17 against its plain
   version bit for bit on the last segment whole (padding rows included)
   and the first 65,536 rows of every segment, the derived and part lanes
   checked as exact functions of the base ids over the whole stack, K17
   timed beside its plain version and its bound (integer operations at
   the SMs' issue rate, or the bytes it writes); p50s of --repeats per
   query; device and peak bytes.
18. realtime: the upsert table baseballStats_REALTIME (the quickstart
   schema, rows from tools/baseball.make_columns, upsert FULL on
   (playerName, yearID, teamID, league): 957,120 keys), ingested as the
   LLC consumer does in fetch batches of 50,000 rows (index_rows, then
   apply_batch); each segment seals at --rt-rows (Apache Pinot's default
   flush threshold, 5,000,000): convert, seal, load on the card,
   attach_or_fold. --rt-sealed segments seal (1 by default, a depth
   cut named in the timing line that keeps the run inside its limit; 2
   is the configuration's); the consuming one is
   checked after each of its last three freeze points (rebuild and lane
   upload timed apart, two fetch batches of tail after each) and when
   full: launch and path counts from 0, phase 9's aggregation, group-by,
   selection and MV group-by families through QueryEngine over every
   segment, each answer against the numpy oracle of the live rows (the
   latest row per key); every K1 launch carries the vdoc node, the
   frozen prefix runs the kernels and the host twin reads the tail
   rows only (and the planner's refusals); p50 of --rt-repeats per
   family (3 by default, a cut of --repeats named in the timing line),
   vdoc uploads and bytes per query. Then it seals too; the sealed set
   runs stacked (every device draw on the stacked route, one K1 with
   the vdoc node over the [S, P] lane, answers the per-segment ones or
   judged by the oracle) and in execute_batch over batch_draws (the
   batched K1 with the shared lane). Ingest rows per second with and
   without apply_batch.
19. join_data: the join tables of tools/datagen.py (make_join_rows from
   --seed: SSB SF10 normalised, --join-rows lineorderj rows, --join-dim-rows
   part rows, 1,000 brands, 10% fact keys without a dim row) built by the
   port's SegmentCreator under build/: lineorderj in --join-segments
   segments, its first two segments' rows again with lo_partkey raw (two
   segments, a depth cut), part in one segment; loaded on the card; rows,
   build and load seconds.
20. join: J0 (no GROUP BY, the K2 path) and the single-join forms of SSB
   flight 2, J2.1-J2.3. Launch counts from 0; per query, stage 1 (the
   dim scan of stages/broker.py:dim_scan_request through the port's
   executor on part, the capacity check, the DataTable published in an
   ExchangeManager), then stage 2 (stages/join.py:build_context over the
   source, attached) per segment, stacked (ShardedQueryExecutor) and, for
   J0, J2.1 and J2.3, on the raw-key segments per segment and stacked;
   every answer equal to join_oracle and to the host twin; K1 with its
   join_raw node, K3 with jcode and jraw keys, K2 and K12
   (radix_sort_join) must have launched, and the raw-key stacked path
   must have launched the join_raw node and, grouped by a dim column,
   the jraw key.
   Then --repeats timed runs: stage 1 and stage 2 p50 per query and path.
21. window: W1 (PARTITION BY d_year ORDER BY lo_revenue DESC, ROW_NUMBER
   and SUM(lo_quantity)) and W2 (ORDER BY d_year, lo_revenue, no
   partition) over a WHERE on lo_partkey chosen from the data to select
   between 32,769 and 65,536 rows (n_pad 65,536): stage 1 (each fact
   segment publishes its window_scan_request scan) -> execute_window_stage
   on the card, launch counts from 0 (K12 radix_sort and K13 window_scan
   must launch); bit-equal to the numpy twin over the same blocks, with
   the rank / telescoping invariants of scripts/join_smoke.py:178-193;
   p50 of --repeats, stage 1 and stage 2 apart.
22. join_kernel_check: K1's member leaf (segment 0, J2.1's dim side) and
   join_raw leaf (the first raw-key segment), K3's jcode and jraw keys (the
   same), K12 as the join build (J2.1's dim keys with their codes) and on
   W1's 65,536-row lanes, K13 on W1's sorted lanes and on 2^24 rows as
   one partition and as singletons (WINDOW_SCAN_REPEATS launches a case,
   each checked), each against its plain version on the card (masks,
   tables, permutations, row numbers and sums bit-equal), timed with the
   L2 flushed beside its bound and the nearest PyTorch call (a gather,
   torch.searchsorted, stable torch.sort, torch.cumsum; for K13 also a
   copy of the same lanes).
23. timing: wall seconds per phase and per part of phase 9 (first runs
   on the card, first runs on the host twin, oracle checks, timed
   repeats), and the depth cuts made to stay inside the time limit.
24. server (after 17 on the SSB table): a ServerInstance on the card over
   the SSB segments (in-memory segments get a content name where the
   artifact CRC goes, so the result cache keys them), started with
   start(port=0), first per segment, then with mesh=make_mesh(); the
   default 2 ms batch window and 4 workers. 16 client threads, each on
   its own ServerConnection, send InstanceRequest bytes at once: Q1.1-
   Q1.3 with literals drawn from --seed (one shape a flight: they
   coalesce), then Q2.1-Q4.3. Every reply is reduced and held to the
   numpy oracle; p50 / p99 per flight, batchedDispatches (must be > 0),
   the batch occupancy distribution, single-flight waits, K1's batched
   launches (counts from 0), then the same round again for the result
   cache's hits.
25. server_residency (after 24): an instance whose device_bytes_budget is
   half the SSB table's ledgered bytes (the lanes the 13 queries read);
   lanes dropped, segments tracked and warmed through the residency
   manager (past the budget: the host tier), then the 13 queries over
   all segments, over the host-tier ones (promotions, demotions) and
   over the others, every answer against the numpy oracle of its rows;
   bytes per tier, the ledger, demotions, promotions, p50 by the tiers a
   reply ran on.
26. server_kernel_check (after 22, on the first raw-key segment): K1's
   batched form with the join_raw leaf at 2, 4 and 8 members (J2.1's and
   J2.3's dim sides and six p_category ones, padded to one Dp) against
   its plain version and B single launches, bit for bit, timed beside 8
   single launches, one torch.searchsorted per member and its bound;
   then join_batch: eight J0-shaped raw-key join members (their own dim
   filters and quantity bounds; stage 1 through the part table's
   ServerInstance) in one execute_batch with counts from 0, each against
   join_oracle, the batched join_raw node launched once a segment a
   signature.
27. server_exchange (after 26): J2.1's stage 1 published on the part
   table's instance (started with start(port=0)) and stage 2 on a second
   instance over the fact segments, fetching the block over TCP (a
   source with only the address) and in process (with the registry
   key): both equal to join_oracle, their stage-2 p50s of 5.
Stage 1 of every join (phases 20, 26, 27) is an InstanceRequest with
publish_exchange to the part table's ServerInstance.

Phases 10-12 run right after the phase they build on (10 and 11 after
5, 12 after 9; 11b after 11, 12b after 12); 13-15 after 12b; 16 and
17 after each table's own phases; 17a and 17b after the SSB table's 17,
before 6; 24 and 25 after 17 on the SSB table; 19-22, 26 and 27 after
17; 18 last.
The last three lines are the card's name and power limit, the kernels
JSON line (launches over every path: SSB and baseballStats per segment
and stacked, the vector table's build, its queries per segment and
stacked, and the batches; the stacked paths' launches, the stacked
launch's time, S per-segment launches' time and the stacked bound beside
them; for a batched kernel, its time at 8 members beside 8 single
launches; filter_mask[vdoc] and filter_mask_batched[vdoc], K1's launches
with the vdoc node on the realtime path; filter_mask[join_raw],
dense_group_aggregate[jcode] and [jraw], the join phase's launches with
those nodes; radix_sort_join, radix_sort and window_scan; block_compact,
slot_tables, rank_slots, radix_sort_rank, dense_group_aggregate[idoff]
and [idrank], with the case their times come from; ssb_synth, the
synthesis phase's launch; filter_mask_batched[join_raw], the
join_batch phase's launches, its times from server_kernel_check; the
server phases' launches count with the batches') and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch, numpy and pinot_tpu_torch only.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
CSUMS_RTOL = 1e-9               # f64 atomics add in a run-dependent order
ROWS_PER_SF = 6_000_000
L2_FLUSH_BYTES = 128 << 20      # > the 50 MB L2: each timed launch is cold
WINDOW_SCAN_REPEATS = 10        # K13 launches a case, each bit-checked
SPIN_CYCLES = 2_000_000         # ~1 ms at H100 clocks


#: the kernels of the SSB and baseballStats paths (K1-K7)
TABLE_KERNELS = ("filter_mask", "masked_part_sums", "dense_group_aggregate",
                 "masked_histogram", "masked_reduce", "masked_select",
                 "hll_registers")
#: the vector path's kernels (K8, K6's vector kind, K9, K10, K11)
VECTOR_KERNELS = ("vector_scores", "masked_select_vector", "ivf_probe_select",
                  "ivf_assign", "ivf_recenter")
VEC_RECALL_GATE, VEC_SCAN_GATE = 0.95, 0.15   # scripts/vec_ann_bench.py


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2, spins: int = 1) -> float:
    """Mean device time of fn() over reps calls, L2 flushed before each.

    A spin of about `spins` milliseconds on the card precedes each call,
    so the host enqueues the call while the card is still busy and the
    events bracket the device work, not the wrapper's Python (a call that
    launches S kernels takes S spins). A call that waits for the card
    itself (the plain versions' boolean indexing) still counts its host
    time."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES * spins)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def launch_breakdown(fn, reps: int = 5) -> dict:
    """{kernel: [mean device µs a launch, launches recorded]} for the
    kernels fn() launches, under torch.profiler over `reps` calls, the L2
    flushed before each call as time_ms flushes it (the flush's own uint8
    fill is left out). The mean is over the launches the profiler
    recorded, which in a process that has profiled before can be fewer
    than reps a kernel. {"error": ...} where the profiler fails: the
    breakdown only explains a time, it checks nothing."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if not us or not ev.count or "unsigned char" in ev.key or \
                    not str(ev.device_type).endswith("CUDA"):
                continue
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "").strip()[:80]
            total, n = out.get(name, (0.0, 0))
            out[name] = (total + us, n + ev.count)
        return {k: [total / n, n] for k, (total, n) in out.items()}
    except Exception as e:  # noqa: BLE001 - a diagnostic, never a check
        return {"error": repr(e)}


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plan_operands(seg, pql):
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    request = BrokerRequestOptimizer().optimize(compile_pql(pql))
    # compaction off: the K3 checks time the dense direct-keyed route
    plan = InstancePlanMaker(allow_group_compaction=False
                             ).make_segment_plan(seg, request)
    return plan, gather_operands(plan)


def group_operands(plan, cols):
    from pinot_tpu_torch.ops import kernels as K
    gcols, strides, g_pad, gaggs, _ = plan.group_spec
    params = list(plan.group_params)
    device = next(iter(cols.values())).device
    keys = [K.spec_group_key(g, cols, params, device) for g in gcols]
    parts = [cols[f"{s[1]}.parts"] for s in gaggs if s[3] and
             s[3][0] == "psums"]
    floats = [cols[f"{s[1]}.{'vlane' if s[2] == 'sv' else 'raw'}"].double()
              for s in gaggs if s[3] and s[3][0] == "csums"]
    extremes = []
    for fname, col, source, extra in gaggs:
        whiches = {"min": ("min",), "max": ("max",),
                   "minmaxrange": ("min", "max")}.get(fname, ())
        for which in whiches:
            kind = "ids" if source == "sv" else "raw"
            extremes.append((kind, cols[f"{col}.{kind}"], which,
                             extra[1] if kind == "ids" else 0))
    return keys, strides, g_pad, parts, floats, extremes


def k3_check(P, plan, cols, mask, extra_bytes: int = 0):
    """K3 against its plain version on one group-by plan, with the
    shared-memory tables as the wrapper chooses them and, where the table
    fits a block's shared memory, forced on and forced off: (report, ms,
    plain ms, bound). `extra_bytes`: inputs the bound reads once beside
    the lanes (a join key's code table or sorted keys)."""
    from pinot_tpu_torch.ops import kernels as K
    keys, strides, g_pad, parts, floats, ext = group_operands(plan, cols)
    args = (mask, keys, strides, g_pad, parts, floats, ext)
    ref = K.dense_group_aggregate_plain(*args)
    combos = int(ref[0].sum())       # (doc, MV entry combination) pairs
    n_l = sum(p.shape[0] for p in parts)
    n_raw = sum(e[0] == "raw" for e in ext)
    table = g_pad * (4 * (1 + n_l + len(ext) - n_raw) +
                     8 * (len(floats) + n_raw))
    smem_room = getattr(torch.cuda.get_device_properties(0),
                        "shared_memory_per_block_optin", 227 << 10) - 2048
    variants = {"default": K.K3_SMEM_SLOTS}
    if table <= smem_room:
        variants.update(smem_on=K.INT32_MAX, smem_off=0)
    int_err, f_err, f_ok, ext_equal = 0, 0.0, True, True
    for slots in variants.values():
        got = K.dense_group_aggregate(*args, smem_slots=slots)
        int_err = max([int_err] + [
            int((a.long() - b.long()).abs().max()) for a, b in
            ((got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3]))
            if a.numel()])
        # min / max are order-free: equal, sentinels and NaN-free data alike
        ext_equal &= all(torch.equal(a, b) for a, b in zip(got[4], ref[4]))
        if floats:
            diff = (got[2] - ref[2]).abs()
            f_err = max(f_err, float(diff.max()))
            f_ok &= bool((diff <= CSUMS_RTOL *
                          ref[2].abs().clamp_min(1.0)).all())
    matched = int(mask.sum())
    if int_err != 0 or not f_ok or not ext_equal:
        raise AssertionError(f"dense_group_aggregate disagrees: int "
                             f"{int_err}, csums {f_err}, extremes equal "
                             f"{ext_equal}")
    # each input read once: the mask, the matched rows' key entries (a [W]
    # row per MV key) and metric lanes; the table written once
    row_bytes = sum(k.lane.element_size() * k.width for k in keys) + n_l + \
        8 * len(floats) + sum(e[1].element_size() for e in ext)
    ms = {v: time_ms(lambda: K.dense_group_aggregate(*args, smem_slots=s))
          for v, s in variants.items()}
    plain = time_ms(lambda: K.dense_group_aggregate_plain(*args))
    b = bound(P + matched * row_bytes + table + extra_bytes,
              combos * (2 * len(keys) + 1 + n_l + len(floats) + len(ext)))
    report = {"g_pad": g_pad, "key_kinds": [k.kind for k in keys],
              "table_bytes": table, "matched": matched, "combos": combos,
              "max_abs_err_int": int_err, "max_abs_err_csums": f_err,
              "part_lanes": n_l, "float_lanes": len(floats),
              "extremes": len(ext), "extremes_equal": ext_equal,
              "csums_rtol": CSUMS_RTOL if floats else None,
              "smem_slots": K.K3_SMEM_SLOTS, "ms": ms["default"],
              "ms_smem_on": ms.get("smem_on"),
              "ms_smem_off": ms.get("smem_off"), "plain_ms": plain,
              "bound_ms": b[0], "bound_by": b[1]}
    return report, max(int_err, f_err), ms["default"], plain, b


def kernel_check(seg, pqls):
    """Each kernel against its plain version on segment 0's lanes."""
    from pinot_tpu_torch.ops import kernels as K
    P, n = seg.padded_docs, seg.num_docs
    report, entries = [], {}

    # K1 on every SSB filter, plus the kinds SSB does not use
    k1_err = 0
    for q, pql in pqls.items():
        plan, cols = plan_operands(seg, pql)
        got = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
        ref = K.filter_mask_plain(P, plan.filter_spec, cols, plan.params, n)
        err = int((got.int() - ref.int()).abs().max())
        report.append({"kernel": "filter_mask", "case": q,
                       "matched": int(ref.sum()), "max_abs_err": err})
        k1_err = max(k1_err, err)
    _, cols = plan_operands(seg, pqls["q4.3"])
    member = np.zeros(1024, bool)
    member[::3] = True
    extra = ("or", (("and", (("pred", "neq_id", "s_city", "sv", None),
                             ("pred", "member", "p_brand1", "sv", 1024))),
                    ("pred", "notin_ids", "c_region", "sv", 4)))
    extra_params = [np.int32(7), member, np.array([0, 1, 2, -1], np.int32)]
    got = K.filter_mask(P, extra, cols, extra_params, n)
    ref = K.filter_mask_plain(P, extra, cols, extra_params, n)
    err = int((got.int() - ref.int()).abs().max())
    report.append({"kernel": "filter_mask", "case": "neq/member/notin",
                   "matched": int(ref.sum()), "max_abs_err": err})
    k1_err = max(k1_err, err)

    # K1 and K2 timed on Q1.1 (three id lanes, three part lanes)
    plan, cols = plan_operands(seg, pqls["q1.1"])
    lanes = {k: cols[k] for k in K.filter_lane_keys(plan.filter_spec)}
    mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
    matched = int(mask.sum())
    k1_bytes = sum(t.numel() * t.element_size() for t in lanes.values()) + P
    entries["filter_mask"] = dict(
        max_abs_err=k1_err,
        ms=time_ms(lambda: K.filter_mask(P, plan.filter_spec, cols,
                                         plan.params, n)),
        plain_ms=time_ms(lambda: K.filter_mask_plain(
            P, plan.filter_spec, cols, plan.params, n)),
        bound=bound(k1_bytes, P * 2 * len(lanes)), library_ms=None)
    parts = [cols["lo_revenue.parts"]]
    L = parts[0].shape[0]
    got = K.masked_part_sums(mask, parts)
    ref = K.masked_part_sums_plain(mask, parts)
    k2_err = int((got.long() - ref.long()).abs().max())
    report.append({"kernel": "masked_part_sums", "case": "q1.1",
                   "matched": matched, "max_abs_err": k2_err})
    entries["masked_part_sums"] = dict(
        max_abs_err=k2_err,
        ms=time_ms(lambda: K.masked_part_sums(mask, parts)),
        plain_ms=time_ms(lambda: K.masked_part_sums_plain(mask, parts)),
        bound=bound(P + matched * L + 4 * (L + 1), P + matched * L),
        library_ms=None)
    # K1's vdoc node: Q1.1 with an upsert bitmap
    entries["filter_mask[vdoc]"] = vdoc_check(seg, plan, cols,
                                              "ssb q1.1 with a bitmap", 1)

    # K3 on every group-by (g_pad 256 to 2^21); Q4.3 (one csums lane)
    # gives the kernels line its numbers
    for q, pql in pqls.items():
        plan, cols = plan_operands(seg, pql)
        if plan.group_spec is None:
            continue
        mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
        r, err, ms, plain, b = k3_check(P, plan, cols, mask)
        report.append({"kernel": "dense_group_aggregate", "case": q, **r})
        if q == "q4.3":
            entries["dense_group_aggregate"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound=b,
                library_ms=None)
    for r in report:
        emit({"phase": "kernel_check", **r})
    if k1_err or k2_err:
        raise AssertionError(f"filter_mask err {k1_err}, masked_part_sums "
                             f"err {k2_err}")
    return entries


#: baseballStats plans whose operands the kernel check takes
BB_K1_PQLS = {
    "raw": "SELECT COUNT(*) FROM baseballStats WHERE salary > 123456.78 "
           "AND salary <= 987654.25 AND runs < 100",
    "mv": "SELECT COUNT(*) FROM baseballStats WHERE position = 'SS' OR "
          "position NOT IN ('P', 'C')",
    "mixed": "SELECT COUNT(*) FROM baseballStats WHERE (teamID IN ('BOS', "
             "'NYA') AND position = 'P') OR salary IN (1.5, 2.25) OR "
             "hits > 240",
}
BB_K3_PQLS = {
    "teamID x league": "SELECT COUNT(*), SUM(runs), AVG(salary), "
                       "MIN(runs), MAX(salary), MINMAXRANGE(average) FROM "
                       "baseballStats WHERE yearID >= 2000 GROUP BY "
                       "teamID, league TOP 2000",
    "playerName": "SELECT MIN(runs), MAX(salary), MINMAXRANGE(average), "
                  "MIN(hits) FROM baseballStats WHERE position = 'C' "
                  "GROUP BY playerName TOP 2000",
    # MV keys ("mvids", "mvin"): count, SUM(hits) part sums, MIN(runs)
    "position": "SELECT COUNT(*), SUM(hits), MIN(runs) FROM baseballStats "
                "WHERE yearID >= 2000 GROUP BY position TOP 100",
    "position x league": "SELECT COUNT(*), SUM(hits), MIN(runs) FROM "
                         "baseballStats WHERE yearID >= 2000 GROUP BY "
                         "position, league TOP 100",
    "valuein(position) x league": "SELECT COUNT(*), SUM(hits), MIN(runs) "
                                  "FROM baseballStats WHERE yearID >= 2000 "
                                  "GROUP BY valuein(position, 'P', 'C', "
                                  "'SS', 'CF'), league TOP 100",
    # float64 sums alone (csums over the raw salary lane)
    "teamID csums salary": "SELECT SUM(salary) FROM baseballStats WHERE "
                           "yearID >= 2000 GROUP BY teamID TOP 100",
}
#: the raw-key segment's K3 case ("rawoff" over int64 hits)
BB_RAW_K3_PQL = "SELECT COUNT(*), SUM(runs), MIN(hits) FROM baseballStats " \
    "WHERE yearID >= 2000 GROUP BY hits, league TOP 1000"
#: the mask and part lanes of the K2, K4 and K5 cases
BB_AGG_PQL = "SELECT SUM(runs), AVG(hits) FROM baseballStats WHERE " \
    "yearID >= 2000"


def bb_kernel_check(seg, raw_seg):
    """K1 raw / MV programs, K2, K3 (MV, valuein and, on the raw-key
    segment, raw keys), K4 (ids and MV entries), K5 (ids, raw and MV
    entries) and K7 against their plain versions on one baseballStats
    segment's lanes."""
    from pinot_tpu_torch.ops import kernels as K
    P, n = seg.padded_docs, seg.num_docs
    report, entries = [], {}

    for case, pql in BB_K1_PQLS.items():
        plan, cols = plan_operands(seg, pql)
        got = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
        ref = K.filter_mask_plain(P, plan.filter_spec, cols, plan.params, n)
        err = int((got.int() - ref.int()).abs().max())
        lanes = [cols[k] for k in K.filter_lane_keys(plan.filter_spec)]
        b = bound(sum(t.numel() * t.element_size() for t in lanes) + P,
                  P * 2 * sum(t.numel() // P for t in lanes))
        report.append({
            "kernel": "filter_mask", "case": f"baseball {case}",
            "matched": int(ref.sum()), "max_abs_err": err,
            "ms": time_ms(lambda: K.filter_mask(
                P, plan.filter_spec, cols, plan.params, n)),
            "plain_ms": time_ms(lambda: K.filter_mask_plain(
                P, plan.filter_spec, cols, plan.params, n)),
            "bound_ms": b[0], "bound_by": b[1]})
        if err:
            raise AssertionError(f"filter_mask disagrees on {case}")

    for case, pql, s in [(c, q, seg) for c, q in BB_K3_PQLS.items()] + \
            [("rawoff hits x league", BB_RAW_K3_PQL, raw_seg)]:
        plan, cols = plan_operands(s, pql)
        mask = K.filter_mask(s.padded_docs, plan.filter_spec, cols,
                             plan.params, s.num_docs)
        r, _err, _ms, _plain, _b = k3_check(s.padded_docs, plan, cols, mask)
        report.append({"kernel": "dense_group_aggregate",
                       "case": f"baseball {case}", **r})

    plan, cols = plan_operands(seg, BB_AGG_PQL)
    mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
    matched = int(mask.sum())
    parts = [cols["runs.parts"], cols["hits.parts"]]
    L = sum(p.shape[0] for p in parts)
    got = K.masked_part_sums(mask, parts)
    ref = K.masked_part_sums_plain(mask, parts)
    err = int((got.long() - ref.long()).abs().max())
    b = bound(P + matched * L + 4 * (L + 1), P + matched * L)
    report.append({
        "kernel": "masked_part_sums", "case": "baseball runs, hits",
        "part_lanes": L, "matched": matched, "max_abs_err": err,
        "ms": time_ms(lambda: K.masked_part_sums(mask, parts)),
        "plain_ms": time_ms(lambda: K.masked_part_sums_plain(mask, parts)),
        "bound_ms": b[0], "bound_by": b[1]})
    if err:
        raise AssertionError("masked_part_sums disagrees on runs, hits")
    lanes = {c: seg.data_source(c).device_dict_ids()
             for c in ("teamID", "playerName", "average", "runs")}
    lanes["salary"] = seg.data_source("salary").device_raw_values()
    mask_f = mask.to(torch.float32)
    for col in ("teamID", "playerName", "average"):
        ids = lanes[col]
        card_pad = K.pow2_bucket(seg.data_source(col).metadata.cardinality
                                 + 1)
        got = K.masked_histogram(mask, ids, card_pad)
        ref = K.masked_histogram_plain(mask, ids, card_pad)
        err = int((got.long() - ref.long()).abs().max())
        ids_long = ids.long()
        b = bound(P + matched * ids.element_size() + 4 * card_pad, matched)
        r = {"kernel": "masked_histogram", "case": f"baseball {col}",
             "card_pad": card_pad, "matched": matched, "max_abs_err": err,
             "ms": time_ms(lambda: K.masked_histogram(mask, ids, card_pad)),
             "plain_ms": time_ms(lambda: K.masked_histogram_plain(
                 mask, ids, card_pad)),
             "library_ms": time_ms(lambda: torch.bincount(
                 ids_long, weights=mask_f, minlength=card_pad)),
             "bound_ms": b[0], "bound_by": b[1]}
        report.append(r)
        if err:
            raise AssertionError(f"masked_histogram disagrees on {col}")
        if col == "teamID":
            entries["masked_histogram"] = dict(
                max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
                bound=b, library_ms=r["library_ms"])

    for case, kind, lane, card_pad, want_sum in (
            ("salary", "raw", lanes["salary"], 0, True),
            ("runs ids", "ids", lanes["runs"], K.pow2_bucket(
                seg.data_source("runs").metadata.cardinality + 1), False)):
        got = K.masked_reduce(mask, lane, kind, card_pad, want_sum)
        ref = K.masked_reduce_plain(mask, lane, kind, card_pad, want_sum)
        equal = all(got[k].dtype == ref[k].dtype and torch.equal(got[k],
                                                                 ref[k])
                    for k in ("min", "max", "count"))
        s_err = float((got["sums"] - ref["sums"]).abs().max()) \
            if want_sum else 0.0
        s_ok = not want_sum or bool(
            ((got["sums"] - ref["sums"]).abs() <=
             CSUMS_RTOL * ref["sums"].abs().clamp_min(1.0)).all())
        out_bytes = (P // K.BLOCK) * 8 * want_sum + 24
        b = bound(P + matched * lane.element_size() + out_bytes,
                  matched * (3 if want_sum else 2))
        r = {"kernel": "masked_reduce", "case": f"baseball {case}",
             "matched": matched, "min_max_count_equal": equal,
             "max_abs_err_sums": s_err,
             "sums_rtol": CSUMS_RTOL if want_sum else None,
             "ms": time_ms(lambda: K.masked_reduce(mask, lane, kind,
                                                   card_pad, want_sum)),
             "plain_ms": time_ms(lambda: K.masked_reduce_plain(
                 mask, lane, kind, card_pad, want_sum)),
             "bound_ms": b[0], "bound_by": b[1]}
        report.append(r)
        if not equal or not s_ok:
            raise AssertionError(f"masked_reduce disagrees on {case}")
        if case == "salary":
            entries["masked_reduce"] = dict(
                max_abs_err=s_err, ms=r["ms"], plain_ms=r["plain_ms"],
                bound=b, library_ms=None)
    report.extend(mv_kernel_check(seg, mask))
    report.extend(hll_kernel_check(seg, mask, entries))
    for r in report:
        emit({"phase": "bb_kernel_check", **r})
    return entries


def mv_lanes(seg):
    """position's MV lane and an int16 MV lane built for the check:
    playerName's ids, 1-3 entries per row like position (padding entries
    hold the cardinality, 997)."""
    P, n = seg.padded_docs, seg.num_docs
    ds = seg.data_source("position")
    card = ds.metadata.cardinality
    pos = ds.device_mv_dict_ids()
    rng = np.random.default_rng(7)
    wide = np.full((P, 3), 997, np.int16)
    wide[:n] = rng.integers(0, 997, (n, 3))
    width = rng.integers(1, 4, n)
    wide[:n][np.arange(3)[None, :] >= width[:, None]] = 997
    return {"position": (pos, card),
            "int16 x 3": (torch.from_numpy(wide).to(pos.device), 997)}


def mv_kernel_check(seg, mask):
    """K4 over MV entries (position) and K5's MV entry min / max
    (position, and an int16 MV lane), against their plain versions."""
    from pinot_tpu_torch.ops import kernels as K
    P = seg.padded_docs
    matched = int(mask.sum())
    report = []
    for case, (lane, card) in mv_lanes(seg).items():
        card_pad = K.pow2_bucket(card + 1)
        W, esize = lane.shape[1], lane.element_size()
        if case == "position":
            got = K.masked_entry_histogram(mask, lane, card_pad, card)
            ref = K.masked_entry_histogram_plain(mask, lane, card_pad, card)
            equal = all(torch.equal(a, b) for a, b in zip(got, ref))
            flat = lane.reshape(-1).long()
            weight = (mask.bool()[:, None] & (lane < card)).reshape(-1) \
                .to(torch.float32)
            b = bound(P + matched * W * esize + 4 * card_pad + 4,
                      matched * W)
            report.append({
                "kernel": "masked_histogram", "case": f"baseball MV {case}",
                "card_pad": card_pad, "width": W, "matched": matched,
                "entries": int(ref[1]), "equal": equal, "max_abs_err": 0,
                "ms": time_ms(lambda: K.masked_entry_histogram(
                    mask, lane, card_pad, card)),
                "plain_ms": time_ms(lambda: K.masked_entry_histogram_plain(
                    mask, lane, card_pad, card)),
                "library_ms": time_ms(lambda: torch.bincount(
                    flat, weights=weight, minlength=card_pad)),
                "bound_ms": b[0], "bound_by": b[1]})
            if not equal:
                raise AssertionError("masked_histogram disagrees on MV "
                                     "position")
        got = K.masked_reduce(mask, lane, "ids", card_pad, card=card)
        ref = K.masked_reduce_plain(mask, lane, "ids", card_pad, card=card)
        equal = all(got[k].dtype == ref[k].dtype and torch.equal(got[k],
                                                                 ref[k])
                    for k in ("min", "max", "count"))
        b = bound(P + matched * W * esize + 24, 2 * matched * W)
        report.append({
            "kernel": "masked_reduce", "case": f"baseball MV {case}",
            "width": W, "matched": matched, "min_max_count_equal": equal,
            "min": int(got["min"]), "max": int(got["max"]),
            "ms": time_ms(lambda: K.masked_reduce(mask, lane, "ids",
                                                  card_pad, card=card)),
            "plain_ms": time_ms(lambda: K.masked_reduce_plain(
                mask, lane, "ids", card_pad, card=card)),
            "bound_ms": b[0], "bound_by": b[1]})
        if not equal:
            raise AssertionError(f"masked_reduce disagrees on MV {case}")
    return report


def hll_kernel_check(seg, mask, entries):
    """K7 on playerName and teamID, after K4 on the same mask; the
    kernels-line entry is playerName's."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M
    m = 1 << DEFAULT_LOG2M
    report = []
    for col in ("playerName", "teamID"):
        ds = seg.data_source(col)
        card = ds.metadata.cardinality
        card_pad = K.pow2_bucket(card + 1)
        hist = K.masked_histogram(mask, ds.device_dict_ids(), card_pad)
        idx, rank = ds.device_hll_idx(), ds.device_hll_rank()
        got = K.hll_registers(hist, idx, rank, m)
        ref = K.hll_registers_plain(hist, idx, rank, m)
        equal = torch.equal(got, ref)
        idx_long = idx.long()
        zeros = torch.zeros(m, dtype=torch.int32, device=hist.device)
        b = bound(12 * card_pad + 4 * m, card_pad)
        r = {"kernel": "hll_registers", "case": f"baseball {col}",
             "card": card, "card_pad": card_pad, "registers": m,
             "nonzero_registers": int((got > 0).sum()), "equal": equal,
             "max_abs_err": int((got - ref).abs().max()),
             "ms": time_ms(lambda: K.hll_registers(hist, idx, rank, m)),
             "plain_ms": time_ms(lambda: K.hll_registers_plain(
                 hist, idx, rank, m)),
             "library_ms": time_ms(lambda: zeros.scatter_reduce(
                 0, idx_long, torch.where(hist > 0, rank, 0), "amax")),
             "bound_ms": b[0], "bound_by": b[1]}
        report.append(r)
        if not equal:
            raise AssertionError(f"hll_registers disagrees on {col}")
        if col == "playerName":
            entries["hll_registers"] = dict(
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound=b,
                library_ms=r["library_ms"])
    return report


#: the select specs of the K6 check come from these plans (segment 0's
#: lanes, with k and the mask varied)
SELECT_PQLS = {
    "limit": "SELECT playerName, salary, position FROM baseballStats "
             "LIMIT 16",
    "order runs, hits": "SELECT runs, hits, playerName FROM baseballStats "
                        "ORDER BY runs DESC, hits DESC LIMIT 16",
    "order league (ties)": "SELECT league, teamID FROM baseballStats "
                           "ORDER BY league LIMIT 16",
    "ordertk salary": "SELECT playerName, salary FROM baseballStats ORDER "
                      "BY salary DESC LIMIT 16",
    "ordermk teamID, salary": "SELECT teamID, yearID, salary FROM "
                              "baseballStats ORDER BY teamID, salary "
                              "LIMIT 16",
}
SELECT_KS = (16, 2048, 65536)


def _select_library(spec, cols, mask, words):
    """One PyTorch call computing the same docids where there is one:
    torch.nonzero for limit, torch.topk over the int64 key (word, docid)
    with masked rows at the top for one key word; else None."""
    kind, k = spec[0], spec[1]
    if kind == "limit":
        return lambda: torch.nonzero(mask)[:k]
    if len(words) != 1:
        return None
    doc = torch.arange(mask.shape[0], device=mask.device, dtype=torch.int64)
    key = ((words[0].long() + 2**31) << 31) | doc
    key = torch.where(mask.bool(), key, torch.iinfo(torch.int64).max)
    return lambda: torch.topk(key, k, largest=False, sorted=True)


def select_kernel_check(seg):
    """K6 against its plain version on one baseballStats segment, every
    select kind, k and mask; returns the kernels-line entry (ordertk on
    salary, k = 2048, yearID >= 2000: the fixed query's kind)."""
    from pinot_tpu_torch.ops import kernels as K
    P, n = seg.padded_docs, seg.num_docs
    device = seg.device
    plan, mcols = plan_operands(seg, BB_AGG_PQL)        # yearID >= 2000
    masks = {"yearID >= 2000": K.filter_mask(P, plan.filter_spec, mcols,
                                             plan.params, n),
             "match-all": K.filter_mask(P, ("match_all",), {}, [], n, device),
             "empty": torch.zeros(P, dtype=torch.uint8, device=device)}
    specs = {}
    for case, pql in SELECT_PQLS.items():
        plan, cols = plan_operands(seg, pql)
        specs[case] = (plan.select_spec, cols)
    # int64 and float64 key lanes built for the check: hits and average
    # decoded from their dictionaries
    wide = {}
    for col, dtype in (("hits", np.int64), ("average", np.float64)):
        ds = seg.data_source(col)
        lane = np.zeros(P, dtype)
        lane[:n] = np.asarray(ds.dictionary.values, dtype)[ds.dict_ids]
        wide[f"{col}.raw"] = torch.from_numpy(lane).to(device)
    specs["ordermk hits int64, average float64"] = (
        ("ordermk", 16, (("hits", False, 0, "raw"),
                         ("average", True, 0, "raw")),
         (("hits", "raw"), ("average", "raw"))), wide)
    report, entry = [], None
    for case, (spec, cols) in specs.items():
        words = K.select_key_words(spec, cols)
        key_bytes = sum(cols[K.gather_lane_key(c, s)].element_size()
                        for c, _asc, _cp, s in spec[2])
        row_bytes = sum(cols[K.gather_lane_key(c, s)][0].numel() *
                        cols[K.gather_lane_key(c, s)].element_size()
                        for c, s in spec[3])
        for mask_name, mask in masks.items():
            matched = int(mask.sum())
            for k in (k for k in SELECT_KS if k <= P):
                sk = (spec[0], k, spec[2], spec[3])
                got = K.masked_select(sk, cols, mask)
                ref = K.selection_outputs_plain(sk, cols, mask)
                equal = set(got) == set(ref) and all(
                    got[x].dtype == ref[x].dtype and torch.equal(
                        got[x].reshape(-1).view(torch.uint8),
                        ref[x].reshape(-1).view(torch.uint8))
                    for x in ref)
                if not equal:
                    raise AssertionError(f"masked_select disagrees: {case}, "
                                         f"{mask_name}, k={k}")
                lib = _select_library(sk, cols, mask, words)
                b = bound(P + matched * key_bytes + k * (4 + 2 * row_bytes)
                          + 4, 0)
                r = {"kernel": "masked_select", "case": case,
                     "kind": spec[0], "mask": mask_name, "k": k,
                     "matched": matched, "key_words": len(words),
                     "equal": equal, "max_abs_err": 0,
                     "ms": time_ms(lambda: K.masked_select(sk, cols, mask),
                                   reps=5),
                     "plain_ms": time_ms(lambda: K.selection_outputs_plain(
                         sk, cols, mask), reps=3, warmup=1),
                     "library_ms": time_ms(lib, reps=5) if lib else None,
                     "bound_ms": b[0], "bound_by": b[1]}
                report.append(r)
                if case == "ordertk salary" and k == 2048 and \
                        mask_name == "yearID >= 2000":
                    entry = dict(max_abs_err=0, ms=r["ms"],
                                 plain_ms=r["plain_ms"], bound=b,
                                 library_ms=r["library_ms"])
    for r in report:
        emit({"phase": "select_kernel_check", **r})
    return {"masked_select": entry}


#: selections over the SSB stack for the stacked K6 check (SSB has none
#: of its own): a packed dictId key ("order") and a float64 raw key
#: ("ordermk", two words)
SSB_SELECT_PQLS = {
    "order lo_revenue": "SELECT c_city, s_city, lo_revenue FROM lineorder "
                        "WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND "
                        "3 ORDER BY lo_revenue DESC LIMIT 100",
    "ordermk lo_supplycost": "SELECT d_year, p_brand1, lo_supplycost FROM "
                             "lineorder WHERE c_region = 'ASIA' AND "
                             "s_region = 'ASIA' ORDER BY lo_supplycost DESC "
                             "LIMIT 1000",
}
#: the stacked K3 cases: psums only, the widest c_city x s_city key, and
#: the largest table (g_pad 2^21, psums and csums)
STACKED_K3_QUERIES = ("q2.1", "q3.2", "q4.3")


def stacked_kernel_check(st_engine, pqls):
    """The stacked launches (one over all S segments) against their plain
    stacked versions on the SSB stack, and against S per-segment launches
    of the sequential path: K1 (mask and per-segment matches), K2 (one
    row per segment), K3 (int64 part sums, csums, over the whole stack),
    K6 (per-segment top k), and K4, K5, K7 over the flat rows. Each timed
    as one stacked launch, as S sequential launches, and beside the
    stacked launch's bound. Returns {kernel: stacked numbers}."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands_for
    from pinot_tpu_torch.query.plan import VALID_DOC_COLUMN, \
        InstancePlanMaker, with_valid_doc_mask
    ex = st_engine.sharded
    stack = ex.stack_for(st_engine.segments)
    S, P = stack.n_real, stack.padded_docs
    segs, docs = stack.segments, stack.device_num_docs()
    report, out = [], {}
    # compaction off: the stacked K3 times the dense direct-keyed route
    maker = InstancePlanMaker(allow_group_compaction=False)

    def operands(pql):
        request = BrokerRequestOptimizer().optimize(compile_pql(pql))
        plan = maker.make_segment_plan(stack.plan_segment(), request)
        flat = K.flat_lanes(stack.gather(plan.needed_cols), S, P)
        per = [gather_operands_for(sg, plan.needed_cols) for sg in segs]
        mask, matched = K.filter_mask_stacked(P, S, plan.filter_spec, flat,
                                              plan.params, docs)
        return plan, flat, per, mask, matched

    def seg_masks(mask):
        return [mask[i * P:(i + 1) * P] for i in range(S)]

    def record(name, case, equal, ms, seq_ms, plain_ms, b, **extra):
        r = {"kernel": name, "case": case, "segments": S, "equal": equal,
             "ms": ms, "s_sequential_ms": seq_ms, "plain_ms": plain_ms,
             "bound_ms": b[0], "bound_by": b[1], **extra}
        report.append(r)
        emit({"phase": "stacked_kernel_check", **r})
        if not equal:
            raise AssertionError(f"stacked {name} disagrees on {case}")
        out.setdefault(name, dict(ms=ms, s_sequential_ms=seq_ms,
                                  plain_ms=plain_ms, bound_ms=b[0],
                                  bound_by=b[1], case=case))

    # K1 and K2 on Q1.1 (three id lanes, three part lanes)
    plan, flat, per, mask, matched = operands(pqls["q1.1"])
    ref_mask, ref_matched = K.filter_mask_stacked_plain(
        P, S, plan.filter_spec, flat, plan.params, docs)
    seq = [K.filter_mask(P, plan.filter_spec, c, plan.params, sg.num_docs)
           for sg, c in zip(segs, per)]
    equal = torch.equal(mask, ref_mask) and \
        torch.equal(matched, ref_matched) and torch.equal(torch.cat(seq),
                                                         mask)
    keys = K.filter_lane_keys(plan.filter_spec)
    n_match = int(matched.sum())
    lane_bytes = sum(flat[k].numel() * flat[k].element_size() for k in keys)
    record("filter_mask", "q1.1", equal,
           time_ms(lambda: K.filter_mask_stacked(P, S, plan.filter_spec,
                                                 flat, plan.params, docs)),
           time_ms(lambda: [K.filter_mask(P, plan.filter_spec, c,
                                          plan.params, sg.num_docs)
                            for sg, c in zip(segs, per)], spins=S),
           time_ms(lambda: K.filter_mask_stacked_plain(
               P, S, plan.filter_spec, flat, plan.params, docs), reps=3),
           bound(lane_bytes + S * P + 4 * S, S * P * 2 * len(keys)),
           matched=n_match)
    # K1's vdoc node over the stack's [S, P] liveness lane
    vspec = with_valid_doc_mask(plan.filter_spec)
    vkey = f"{VALID_DOC_COLUMN}.vdoc"
    vflat = dict(flat, **{vkey: liveness_lane(
        S * P, [sg.num_docs for sg in segs], 3)})
    vper = [dict(c, **{vkey: vflat[vkey][i * P:(i + 1) * P]})
            for i, c in enumerate(per)]
    K.reset_launch_counts()
    vmask, vmatched = K.filter_mask_stacked(P, S, vspec, vflat, plan.params,
                                            docs)
    torch.cuda.synchronize()
    if K.launch_counts()["filter_mask[vdoc]"] != 1:
        raise AssertionError("the stacked K1 launched without the vdoc node")
    ref_mask, ref_matched = K.filter_mask_stacked_plain(
        P, S, vspec, vflat, plan.params, docs)
    equal = torch.equal(vmask, ref_mask) and \
        torch.equal(vmatched, ref_matched) and torch.equal(torch.cat([
            K.filter_mask(P, vspec, c, plan.params, sg.num_docs)
            for sg, c in zip(segs, vper)]), vmask)
    record("filter_mask[vdoc]", "q1.1 with a bitmap", equal,
           time_ms(lambda: K.filter_mask_stacked(P, S, vspec, vflat,
                                                 plan.params, docs)),
           time_ms(lambda: [K.filter_mask(P, vspec, c, plan.params,
                                          sg.num_docs)
                            for sg, c in zip(segs, vper)], spins=S),
           time_ms(lambda: K.filter_mask_stacked_plain(
               P, S, vspec, vflat, plan.params, docs), reps=3),
           bound(lane_bytes + 2 * S * P + 4 * S,
                 S * P * 2 * (len(keys) + 1)),
           matched=int(vmatched.sum()), unmasked_matched=n_match)
    parts = [flat["lo_revenue.parts"]]
    L = parts[0].shape[0]
    got = K.masked_part_sums(mask, parts, seg_rows=P)
    equal = torch.equal(got, K.masked_part_sums_plain(mask, parts, P)) and \
        torch.equal(got, torch.stack([
            K.masked_part_sums(m, [c["lo_revenue.parts"]])
            for m, c in zip(seg_masks(mask), per)]))
    record("masked_part_sums", "q1.1", equal,
           time_ms(lambda: K.masked_part_sums(mask, parts, seg_rows=P)),
           time_ms(lambda: [K.masked_part_sums(m, [c["lo_revenue.parts"]])
                            for m, c in zip(seg_masks(mask), per)], spins=S),
           time_ms(lambda: K.masked_part_sums_plain(mask, parts, P),
                   reps=3),
           bound(S * P + n_match * L + 4 * S * (L + 1), S * P + n_match * L),
           matched=n_match, part_lanes=L,
           total_parts_sum=int(got[:, :L].long().sum()))

    # K3 over the whole stack: int64 part sums, float64 csums
    for q in STACKED_K3_QUERIES:
        plan, flat, per, mask, matched = operands(pqls[q])
        keys, strides, g_pad, kparts, floats, ext = group_operands(plan,
                                                                   flat)
        args = (mask, keys, strides, g_pad, kparts, floats, ext)
        got = K.dense_group_aggregate(*args, psums_wide=True)
        ref = K.dense_group_aggregate_plain(*args, psums_wide=True)
        seq_args = [(m,) + group_operands(plan, c) for m, c in
                    zip(seg_masks(mask), per)]
        seq = [K.dense_group_aggregate(*a) for a in seq_args]
        ints_equal = all(torch.equal(a, b) for a, b in
                         ((got[0], ref[0]), (got[1], ref[1]),
                          (got[3], ref[3]))) and \
            all(torch.equal(a, b) for a, b in zip(got[4], ref[4])) and \
            torch.equal(got[1], sum(o[1].long() for o in seq)) and \
            torch.equal(got[0], sum(o[0] for o in seq))
        f_err, f_ok = 0.0, True
        if floats:
            diff = (got[2] - ref[2]).abs()
            f_err = float(diff.max())
            f_ok = bool((diff <= CSUMS_RTOL *
                         ref[2].abs().clamp_min(1.0)).all())
        n_l = sum(p.shape[0] for p in kparts)
        n_match = int(matched.sum())
        row_bytes = sum(k.lane.element_size() for k in keys) + n_l + \
            8 * len(floats)
        table = g_pad * (4 + 8 * n_l + 8 * len(floats))
        record("dense_group_aggregate", q, ints_equal and f_ok,
               time_ms(lambda: K.dense_group_aggregate(*args,
                                                       psums_wide=True)),
               time_ms(lambda: [K.dense_group_aggregate(*a)
                                for a in seq_args], spins=S),
               time_ms(lambda: K.dense_group_aggregate_plain(
                   *args, psums_wide=True), reps=3),
               bound(S * P + n_match * row_bytes + table,
                     n_match * (2 * len(keys) + 1 + n_l + len(floats))),
               matched=n_match, g_pad=g_pad, part_lanes=n_l,
               float_lanes=len(floats), psums_table_bytes=8 * n_l * g_pad,
               per_segment_psums_bytes=4 * S * n_l * g_pad,
               max_abs_err_csums=f_err,
               csums_rtol=CSUMS_RTOL if floats else None)

    # K6: a top k per segment, [S, k]
    for case, pql in SSB_SELECT_PQLS.items():
        plan, flat, per, mask, matched = operands(pql)
        spec = plan.select_spec
        got = K.masked_select(spec, flat, mask, S)
        ref = K.selection_outputs_plain(spec, flat, mask, S)
        seq = [K.masked_select(spec, c, m)
               for c, m in zip(per, seg_masks(mask))]

        def same(a, b):
            return a.dtype == b.dtype and torch.equal(
                a.reshape(-1).view(torch.uint8), b.reshape(-1).view(
                    torch.uint8))
        equal = set(got) == set(ref) and all(
            same(got[x], ref[x]) and same(got[x], torch.stack(
                [o[x] for o in seq])) for x in ref)
        words = K.select_key_words(spec, flat)
        k = spec[1]
        key_bytes = sum(flat[K.gather_lane_key(c, src)].element_size()
                        for c, _asc, _cp, src in spec[2])
        row_bytes = sum(flat[K.gather_lane_key(c, src)][0].numel() *
                        flat[K.gather_lane_key(c, src)].element_size()
                        for c, src in spec[3])
        n_match = int(matched.sum())
        record("masked_select", case, equal,
               time_ms(lambda: K.masked_select(spec, flat, mask, S),
                       reps=5),
               time_ms(lambda: [K.masked_select(spec, c, m) for c, m in
                                zip(per, seg_masks(mask))], reps=5,
                       spins=S),
               time_ms(lambda: K.selection_outputs_plain(spec, flat, mask,
                                                         S), reps=2,
                       warmup=1),
               bound(S * P + n_match * key_bytes +
                     S * k * (4 + 2 * row_bytes) + 4 * S, 0),
               kind=spec[0], k=k, key_words=len(words), matched=n_match,
               scratch_bytes=4 * K.select_scratch_words(P, k, len(words),
                                                        S))

    # K4, K7 and K5 over the flat rows of the stack (Q4.3's mask)
    plan, flat, per, mask, matched = operands(pqls["q4.3"])
    n_match = int(matched.sum())
    ds0 = segs[0].data_source("c_city")
    card_pad = K.pow2_bucket(ds0.metadata.cardinality + 1)
    ids = K.flat_lanes({"c_city.ids": stack.lane("c_city", "ids")}, S,
                       P)["c_city.ids"]
    seg_ids = [sg.data_source("c_city").device_dict_ids() for sg in segs]
    hist = K.masked_histogram(mask, ids, card_pad)
    equal = torch.equal(hist, K.masked_histogram_plain(mask, ids,
                                                       card_pad)) and \
        torch.equal(hist, sum(K.masked_histogram(m, i, card_pad) for m, i in
                              zip(seg_masks(mask), seg_ids)))
    record("masked_histogram", "c_city, q4.3 mask", equal,
           time_ms(lambda: K.masked_histogram(mask, ids, card_pad)),
           time_ms(lambda: [K.masked_histogram(m, i, card_pad) for m, i in
                            zip(seg_masks(mask), seg_ids)], spins=S),
           time_ms(lambda: K.masked_histogram_plain(mask, ids, card_pad)),
           bound(S * P + n_match * ids.element_size() + 4 * card_pad,
                 n_match), matched=n_match, card_pad=card_pad)
    from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M
    m = 1 << DEFAULT_LOG2M
    idx, rank = stack.lane("c_city", "hllidx"), stack.lane("c_city",
                                                           "hllrank")
    regs = K.hll_registers(hist, idx, rank, m)
    seg_regs = [K.hll_registers(K.masked_histogram(mm, i, card_pad),
                                sg.data_source("c_city").device_hll_idx(),
                                sg.data_source("c_city").device_hll_rank(),
                                m)
                for mm, i, sg in zip(seg_masks(mask), seg_ids, segs)]
    equal = torch.equal(regs, K.hll_registers_plain(hist, idx, rank, m)) \
        and torch.equal(regs, torch.stack(seg_regs).amax(dim=0))
    record("hll_registers", "c_city, q4.3 mask", equal,
           time_ms(lambda: K.hll_registers(hist, idx, rank, m)),
           time_ms(lambda: [K.hll_registers(hist, idx, rank, m)
                            for _ in range(S)], spins=S),
           time_ms(lambda: K.hll_registers_plain(hist, idx, rank, m)),
           bound(12 * card_pad + 4 * m, card_pad), registers=m)
    lane = flat["lo_supplycost.raw"]
    got = K.masked_reduce(mask, lane, "raw", 0, True)
    ref = K.masked_reduce_plain(mask, lane, "raw", 0, True)
    seg_lanes = [c["lo_supplycost.raw"] for c in per]
    seq = [K.masked_reduce(mm, ln, "raw", 0, True)
           for mm, ln in zip(seg_masks(mask), seg_lanes)]
    # a block of the stacked launch sums the same 8192 rows in the same
    # order as the per-segment launch: block sums equal bit for bit, and
    # reshape to [S, P / 8192]
    equal = all(torch.equal(got[x], ref[x]) for x in ("min", "max",
                                                      "count")) and \
        torch.equal(got["sums"].reshape(S, -1),
                    torch.stack([o["sums"] for o in seq])) and \
        bool(((got["sums"] - ref["sums"]).abs() <= CSUMS_RTOL *
              ref["sums"].abs().clamp_min(1.0)).all()) and \
        float(got["min"]) == min(float(o["min"]) for o in seq) and \
        float(got["max"]) == max(float(o["max"]) for o in seq)
    record("masked_reduce", "lo_supplycost, q4.3 mask", equal,
           time_ms(lambda: K.masked_reduce(mask, lane, "raw", 0, True)),
           time_ms(lambda: [K.masked_reduce(mm, ln, "raw", 0, True)
                            for mm, ln in zip(seg_masks(mask), seg_lanes)],
                   spins=S),
           time_ms(lambda: K.masked_reduce_plain(mask, lane, "raw", 0,
                                                 True)),
           bound(S * P + n_match * 8 + (S * P // K.BLOCK) * 8 + 24,
                 3 * n_match), matched=n_match)
    return out


def same_answer(a, b, rtol: float) -> bool:
    """Two BrokerResponses give the same rows: equal groups, selection
    rows and integers, floats within rtol."""
    ja, jb = a.to_json(), b.to_json()
    if bool(ja.get("exceptions")) or bool(jb.get("exceptions")) or \
            ja.get("selectionResults") != jb.get("selectionResults"):
        return False

    def values(j):
        out = {}
        for agg in j.get("aggregationResults") or []:
            rows = agg.get("groupByResult")
            if rows is None:
                out[(agg["function"], ())] = agg["value"]
            else:
                for g in rows:
                    out[(agg["function"], tuple(g["group"]))] = g["value"]
        return out
    va, vb = values(ja), values(jb)
    if va.keys() != vb.keys():
        return False
    for k, x in va.items():
        y = vb[k]
        try:
            fx, fy = float(x), float(y)
        except (TypeError, ValueError):
            if x != y:
                return False
            continue
        if not (fx == fy or abs(fx - fy) <= rtol * max(abs(fy), 1e-300)):
            return False
    return True


def run_ssb_stacked(st_engine, seq_results, oracle, repeats: int):
    """The stacked SSB path: per query, launch counts set to 0, the query
    run once through the stacked engine, the counts read (each kernel the
    query uses launched once a dispatch, whatever the number of segments)
    and its route (stacked) checked; the rows
    checked against the numpy oracle and the sequential port's rows; then
    the timed repeats. Returns the path's launch counts."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, canon_response, check
    total = dict.fromkeys(K.launch_counts(), 0)
    firsts = {}
    for q, pql in SSB_PQLS.items():
        K.reset_launch_counts()
        t = time.perf_counter()
        resp = st_engine.query(pql)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        counts = K.launch_counts()
        if st_engine.last_route != ("stacked", None):
            raise AssertionError(f"{q} left the stacked path: "
                                 f"{st_engine.last_route}")
        # a group-by is several dispatches (the scouts, phase B and each
        # kmax rung), each launching its kernels once over the whole
        # stack, K5 and K4 once a group column in a scout
        routes = K.group_route_counts
        dispatches = 1 + routes["scout"] + routes["hist"] + \
            routes["escalation"]
        group_by = compile_pql(pql).group_by
        n_keys = len(group_by.columns) if group_by else 1
        limits = {"masked_reduce": dispatches * n_keys,
                  "masked_histogram": dispatches * n_keys}
        if any(v > limits.get(k, dispatches) for k, v in counts.items()) \
                or not counts["filter_mask"]:
            raise AssertionError(f"{q}: stacked launches {counts} over "
                                 f"{dispatches} dispatches")
        for name, v in counts.items():
            total[name] += v
        if resp.exceptions:
            raise AssertionError(f"{q}: {resp.exceptions}")
        got = canon_response(q, resp)
        check(q, got, oracle[q]())
        want = seq_results[q]
        if q.startswith("q1"):
            same = got == want
        else:
            same = set(got) == set(want) and all(
                got[k][0] == want[k][0] and all(
                    abs(g - w) <= CSUMS_RTOL * max(abs(w), 1.0)
                    for g, w in zip(got[k][1:], want[k][1:]))
                for k in want)
        if not same:
            raise AssertionError(f"{q}: stacked rows differ from the "
                                 "sequential port's")
        firsts[q] = (first_ms, {k: v for k, v in counts.items() if v})
    for q, pql in SSB_PQLS.items():
        ts = []
        for _ in range(repeats):
            t = time.perf_counter()
            st_engine.query(pql)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        emit({"phase": "ssb_stacked", "query": q, "check": "pass",
              "route": "stacked", "first_ms": firsts[q][0],
              "launches": firsts[q][1], "p50_ms": float(np.median(ts)),
              "sequential_p50_ms": seq_results["p50_ms"][q],
              "samples_ms": ts})
    return total


def run_baseball_stacked(st_engine, answered, oracle, repeats: int,
                         seq_p50):
    """The baseballStats mix through the stacked engine over the loaded
    segments (their own dictionaries, stacked through the union remap):
    launch counts set to 0, every draw once, the counts read; each answer
    must equal the sequential port's, which met the oracle in phase
    `baseball` (where they differ, the oracle judges the stacked one);
    the routes counted; then the timed repeats of the stacked draws."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import baseball
    K.reset_launch_counts()
    st_engine.route_counts.clear()
    runs = []
    for family, draw, seq_resp in answered:
        t = time.perf_counter()
        resp = st_engine.query(draw.pql)
        torch.cuda.synchronize()
        runs.append((family, draw, resp, (time.perf_counter() - t) * 1e3,
                     st_engine.last_route, seq_resp))
    launches = K.launch_counts()
    routes, reasons, judged = {}, {}, 0
    for family, draw, resp, _ms, (route, reason), seq_resp in runs:
        label = route
        if route == "NotShardable":
            label = "fast_path" if reason.startswith("fast-path") else \
                "not_shardable"
            if label == "not_shardable":
                reasons[reason] = reasons.get(reason, 0) + 1
        elif route in ("UnsupportedOnDevice", "GroupsLimitExceeded"):
            label = "host_twin"
        routes[label] = routes.get(label, 0) + 1
        if (label == "host_twin") != draw.host_answered:
            raise AssertionError(f"{draw.pql}: route {route}, host twin "
                                 f"expected {draw.host_answered}")
        if not same_answer(resp, seq_resp, baseball.FLOAT_RTOL):
            baseball.check(resp, oracle, draw)
            judged += 1
    if not all(launches[name] for name in TABLE_KERNELS):
        raise AssertionError(f"a kernel never launched on the stacked "
                             f"baseballStats path: {launches}")
    if not routes.get("stacked"):
        raise AssertionError(f"no draw took the stacked route: {routes}")
    families = {}
    for family, draw, resp, first_ms, (route, _r), _s in runs:
        if route != "stacked":
            continue
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            st_engine.query(draw.pql)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        families.setdefault(family, []).extend(ts)
    emit({"phase": "baseball_stacked", "queries_passed": len(runs),
          "routes": routes, "not_shardable_reasons": reasons,
          "judged_by_oracle": judged,
          "p50_ms_by_family": {f: float(np.median(ts))
                               for f, ts in families.items()},
          "sequential_p50_ms_by_family": seq_p50,
          "stack_device_bytes": sum(
              st.device_bytes() for st in st_engine.sharded._stacks.values()),
          "launches": launches})
    return launches


def run_ssb(engine, oracle, repeats: int):
    """The SSB path: counts from 0, the 13 queries once, checked; then the
    timed repeats. Returns the path's launch counts and {query: canonical
    rows, "p50_ms": {query: p50}}."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, canon_response, check
    K.reset_launch_counts()
    results = {}
    for q, pql in SSB_PQLS.items():
        t = time.perf_counter()
        resp = engine.query(pql)
        torch.cuda.synchronize()
        results[q] = (resp, (time.perf_counter() - t) * 1e3)
    launches = K.launch_counts()
    rows = {"p50_ms": {}}
    for q, (resp, _first_ms) in results.items():
        if resp.exceptions:
            raise AssertionError(f"{q}: {resp.exceptions}")
        rows[q] = canon_response(q, resp)
        check(q, rows[q], oracle[q]())
    for name in ("filter_mask", "masked_part_sums", "dense_group_aggregate"):
        if not launches[name]:
            raise AssertionError(f"{name} never launched on the SSB path: "
                                 f"{launches}")
    for q, pql in SSB_PQLS.items():
        ts = []
        for _ in range(repeats):
            t = time.perf_counter()
            engine.query(pql)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        rows["p50_ms"][q] = float(np.median(ts))
        emit({"phase": "ssb", "query": q, "check": "pass",
              "first_ms": results[q][1], "p50_ms": rows["p50_ms"][q],
              "samples_ms": ts})
    return launches, rows


def run_baseball(tables, repeats: int):
    """The baseballStats path: launch and path counts from 0, every draw
    of the mix once, and the raw-key and MV metric tables' queries on their
    own engines, checked against the vectorised oracles; then the timed
    repeats of the device-answered draws. `tables`: (engine, oracle,
    (family, draw) pairs), baseballStats first. Returns the path's launch
    counts, its seconds per part, the (family, draw, response) of each
    baseballStats draw and the p50 per family."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import baseball
    draws = [(f, d, e, o) for e, o, pairs in tables for f, d in pairs]
    seconds = {"device_first_runs": 0.0, "host_first_runs": 0.0}
    K.reset_launch_counts()
    for e, _o, _p in tables:
        e.executor.reset_path_counts()
    answered = []
    for family, draw, eng, orc in draws:
        host_before = eng.executor.path_counts["host"]
        t = time.perf_counter()
        resp = eng.query(draw.pql)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        on_host = eng.executor.path_counts["host"] > host_before
        seconds["host_first_runs" if on_host else "device_first_runs"] += \
            first_s
        answered.append((family, draw, eng, orc, resp, first_s * 1e3,
                         on_host))
    launches = K.launch_counts()
    paths = [dict(e.executor.path_counts) for e, _o, _p in tables]
    t = time.perf_counter()
    for family, draw, _e, orc, resp, _ms, on_host in answered:
        baseball.check(resp, orc, draw)
        if on_host != draw.host_answered:
            raise AssertionError(f"{draw.pql}: answered on the host: "
                                 f"{on_host}, expected {draw.host_answered}")
    seconds["oracle_checks"] = time.perf_counter() - t
    host_draws = [a[1] for a in answered if a[6]]
    # exactly the draws the JAX planner refuses: the 5 group-by
    # DISTINCTCOUNT draws and the MV expression aggregation
    n_refused = sum(d.host_answered for _f, d, _e, _o in draws)
    if len(host_draws) != n_refused or n_refused != 6 or \
            any(d.is_selection for d in host_draws):
        raise AssertionError(f"host path answered {len(host_draws)} draws, "
                             f"expected the {n_refused} refused ones")
    if not paths[0]["pruned"] or not paths[0]["fast"]:
        raise AssertionError(f"the pruner or a fast path never ran: "
                             f"{paths[0]}")
    for p in paths[1:]:
        if p["host"] or not p["scan"]:
            raise AssertionError(f"a raw-key or MV metric query left the "
                                 f"card: {p}")
    if not all(launches[name] for name in TABLE_KERNELS):
        raise AssertionError(f"a kernel never launched on the baseballStats "
                             f"path: {launches}")
    families = {}
    t = time.perf_counter()
    for family, draw, eng, _o, _resp, first_ms, on_host in answered:
        if on_host:
            ts = [first_ms]
            family = f"{family}_host"
        else:
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                eng.query(draw.pql)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
        families.setdefault(family, []).extend(ts)
        emit({"phase": "baseball", "family": family, "pql": draw.pql,
              "check": "pass", "matched": int(draw.mask.sum()),
              "host": on_host, "p50_ms": float(np.median(ts))})
    seconds["timed_repeats"] = time.perf_counter() - t
    p50 = {f: float(np.median(ts)) for f, ts in families.items()}
    emit({"phase": "baseball_summary", "queries_passed": len(answered),
          "host_answered": len(host_draws),
          "p50_ms_by_family": p50,
          "device_table_bytes": sum(s.device_bytes()
                                    for s in tables[0][0].segments),
          "segment_paths": paths[0], "raw_key_segment_paths": paths[1],
          "mv_metric_segment_paths": paths[2], "launches": launches,
          "seconds": seconds})
    main_table = [(f, d, resp) for f, d, e, _o, resp, _ms, _h in answered
                  if e is tables[0][0]]
    return launches, seconds, main_table, p50


# ---------------------------------------------------------------------------
# The compacted filtered group-by: K14, K15, K16, K3's remap keys
# ---------------------------------------------------------------------------

#: the kernels of the compacted group-by, with their own kernel-line
#: entries (no stacked timing: the stacked form is the same launch over
#: [S * P] rows); K12 as K16's sort route is radix_sort_rank
COMPACT_KERNELS = ("block_compact", "slot_tables", "rank_slots",
                   "radix_sort_rank")
#: SSB cases of the kernel check: Q2.1 (idoff keys, dense compacted
#: tables) and Q3.1 (idrank keys, the dense regime: K3)
COMPACT_SSB_CASES = ("q2.1", "q3.1")
#: baseballStats cases: runs x hits (150 x 250 = 37,500 potential groups,
#: in (DENSE_G_LIMIT, 100,000]) under a 0.05% filter takes the ranked
#: layout; playerName x runs x hits (37M potential groups, numGroupsLimit
#: raised) under a 0.1% filter ranks past RANK_BITMAP_G_LIMIT: K16's sort
#: route. The filters keep the groups to a few thousand: finishing them
#: is host work that the on / off comparison repeats
BB_COMPACT_PQLS = {
    "ranked": "SELECT COUNT(*), SUM(salary), MIN(average), MAX(hits) FROM "
              "baseballStats WHERE playerName = 'player_042' AND league = "
              "'AL' GROUP BY runs, hits TOP 100000",
    "ranked_sort": "SELECT COUNT(*), SUM(salary) FROM baseballStats WHERE "
                   "yearID = 2005 AND teamID = 'BOS' AND league = 'AL' "
                   "GROUP BY playerName, runs, hits TOP 100000 "
                   "OPTION(numGroupsLimit=40000000)",
}
#: the crowded case: lineorder sorted on its time column (Pinot's
#: sortedColumn), a one-month filter whose rows fill whole blocks
CROWDED_PQL = ("SELECT SUM(lo_revenue), COUNT(*) FROM lineorder WHERE "
               "d_yearmonth = 'Dec1997' GROUP BY c_nation, p_mfgr TOP 1000")
CROWDED_SEGMENTS = 2
#: timed runs a path of the on / off comparison takes at most (four
#: paths a case)
GROUP_COMPACT_REPEATS = 3


def bb_compact_draws(oracle):
    """The baseballStats cases of the group_compact phase: every device-
    answered draw of the mix that groups under a WHERE, then the ranked
    cases of BB_COMPACT_PQLS as draws the oracle checks."""
    from pinot_tpu_torch.tools import baseball
    aggs = {a[0]: a for a in baseball.AGGS}
    draws = [d for _f, d in baseball.all_draws(oracle)
             if d.dims and " WHERE " in d.pql and not d.host_answered]
    al = oracle.eq("league", "AL")
    draws.append(baseball.Draw(
        "group_by", BB_COMPACT_PQLS["ranked"],
        oracle.eq("playerName", "player_042") & al,
        [aggs[a] for a in ("COUNT(*)", "SUM(salary)", "MIN(average)",
                           "MAX(hits)")], dims=("runs", "hits")))
    draws.append(baseball.Draw(
        "group_by", BB_COMPACT_PQLS["ranked_sort"],
        oracle.eq("yearID", 2005) & oracle.eq("teamID", "BOS") & al,
        [aggs["COUNT(*)"], aggs["SUM(salary)"]],
        dims=("playerName", "runs", "hits")))
    return draws


def final_group_dispatch(seg, plan, cols):
    """Drive a plan's group-by on one segment as the executor does and
    return the last dispatch's (group spec, extra params)."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.query.execution import pull_group_outputs
    from pinot_tpu_torch.query.plan import drive_group_execution
    last = {}

    def run(aggs, gspec, extra=()):
        if gspec is not None:
            last.update(spec=gspec, extra=tuple(extra))
        return pull_group_outputs(K.run_segment_kernel(
            seg.padded_docs, plan.filter_spec, aggs, gspec, None, cols,
            tuple(plan.params), seg.num_docs, seg.device,
            tuple(plan.group_params) + tuple(extra) if gspec is not None
            else ()))

    drive_group_execution(run, plan.group_spec, seg.padded_docs,
                          seg.num_docs)
    return last["spec"], last["extra"]


def _equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def compact_kernel_check(seg, cases):
    """Per case (label, pql): the final dispatch's spec on segment 0, then
    K3 over its remapped keys (every case), K14 (kmax > 0 below the sorted
    rung), K16 (the ranked layout, its route as the wrapper picks it, and
    the sort route forced for radix_sort_rank) and K15, each against its
    plain version (integers equal, float64 sums within CSUMS_RTOL), timed
    with the L2 flushed beside its bound and the nearest PyTorch call.
    Returns {kernel or "dense_group_aggregate[<kind>]": entry}."""
    from types import SimpleNamespace

    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    P, n = seg.padded_docs, seg.num_docs
    entries = {}
    for label, pql in cases:
        plan = InstancePlanMaker().make_segment_plan(
            seg, BrokerRequestOptimizer().optimize(compile_pql(pql)))
        cols = gather_operands(plan)
        spec, extra = final_group_dispatch(seg, plan, cols)
        gcols, strides, g_pad, gaggs, kmax = spec
        mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
        params = list(plan.group_params) + list(extra)
        # K3 over the remapped keys (the dense regime's kernel, and the
        # sorted rung's) where its table is dense
        if g_pad <= K.DENSE_G_LIMIT:
            fake = SimpleNamespace(group_spec=spec,
                                   group_params=list(params))
            r3, err3, ms3, plain3, b3 = k3_check(P, fake, cols, mask)
            emit({"phase": "group_compact_check", "case": label,
                  "kernel": "dense_group_aggregate", "kmax": kmax, **r3})
            for kind in {g[1] for g in gcols} & {"idoff", "idrank"}:
                entries.setdefault(f"dense_group_aggregate[{kind}]", dict(
                    max_abs_err=err3, ms=ms3, plain_ms=plain3, bound=b3,
                    library_ms=None, case=label))
        if not kmax:
            continue
        keys = [K.spec_group_key(g, cols, list(params), seg.device)
                for g in gcols]
        lanes = K._group_lanes(gaggs, cols)
        w = K.group_combos(keys)
        t = P * w // K.CBLOCK
        r = min(max(-(-min(kmax * w, P * w) // t), 8), K.CBLOCK)
        if r > K.SORTED_RUNG_R:
            continue
        ids_lanes = [e[1] for e in lanes.extremes if e[0] == "ids"]
        value_lanes = lanes.floats + [e[1] for e in lanes.extremes
                                      if e[0] == "raw"]
        a14 = (mask, keys, strides, g_pad, r, lanes.parts, value_lanes,
               ids_lanes)
        got, ref = K.block_compact(*a14), K.block_compact_plain(*a14)
        ok14 = all(_equal(a, b) for a, b in zip(got, ref))
        kc, parts_c, vals_c, ids_c, _ovf, _m = got
        cap = t * r
        taken = int((kc < g_pad).sum())
        row_bytes = sum(k.lane.element_size() * k.width for k in keys) + \
            sum(p.shape[0] for p in lanes.parts) + \
            sum(v.element_size() for v in value_lanes + ids_lanes)
        slot_bytes = 4 + parts_c.shape[0] + 8 * vals_c.shape[0] + \
            4 * ids_c.shape[0]
        idx_lanes = [k.lane for k in keys] + [
            p for pl in lanes.parts for p in pl] + value_lanes + ids_lanes

        def library14():
            idx = torch.nonzero(mask).view(-1)
            return [v.index_select(0, idx) for v in idx_lanes]

        e14 = dict(max_abs_err=0 if ok14 else 1,
                   ms=time_ms(lambda: K.block_compact(*a14)),
                   plain_ms=time_ms(lambda: K.block_compact_plain(*a14),
                                    reps=3),
                   bound=bound(P + taken * row_bytes + cap * slot_bytes,
                               P * w),
                   library_ms=time_ms(library14), case=label)
        emit({"phase": "group_compact_check", "case": label,
              "kernel": "block_compact", "g_pad": g_pad, "kmax": kmax,
              "r": r, "cap": cap, "slots_taken": taken,
              "overflow": int(got[4]), "equal": ok14,
              **{k: v for k, v in e14.items() if k != "bound"},
              "bound_ms": e14["bound"][0], "bound_by": e14["bound"][1]})
        if not ok14:
            raise AssertionError(f"block_compact disagrees on {label}")
        entries.setdefault("block_compact", e14)
        ranked = g_pad > K.DENSE_G_LIMIT
        if ranked:
            routes = ["sort"] if g_pad > K.RANK_BITMAP_G_LIMIT else \
                ["bitmap", "sort"]
            ref16 = K.rank_slots_plain(kc, cap, g_pad)
            for route in routes:
                got16 = K.rank_slots(kc, cap, g_pad, route=route)
                ok16 = all(_equal(a, b) for a, b in zip(got16, ref16))
                e16 = dict(
                    max_abs_err=0 if ok16 else 1,
                    ms=time_ms(lambda: K.rank_slots(kc, cap, g_pad,
                                                    route=route)),
                    plain_ms=time_ms(lambda: K.rank_slots_plain(
                        kc, cap, g_pad), reps=3),
                    bound=bound(4 * cap * 3, cap),
                    library_ms=time_ms(lambda: torch.unique(
                        kc, return_inverse=True)), case=label, route=route)
                emit({"phase": "group_compact_check", "case": label,
                      "kernel": "rank_slots", "route": route,
                      "g_pad": g_pad, "cap": cap,
                      "distinct": int(got16[2].sum()), "equal": ok16,
                      **{k: v for k, v in e16.items() if k != "bound"},
                      "bound_ms": e16["bound"][0],
                      "bound_by": e16["bound"][1]})
                if not ok16:
                    raise AssertionError(f"rank_slots ({route}) disagrees "
                                         f"on {label}")
                if route == "sort":
                    # K12 alone on the keys, as the sort route runs it
                    perm, (sk,), _ = K.radix_sort([kc],
                                                  counter="radix_sort_rank")
                    pperm, (psk,), _ = K.radix_sort_plain([kc])
                    ok12 = _equal(perm, pperm) and _equal(sk, psk)
                    entries["radix_sort_rank"] = dict(
                        max_abs_err=0 if ok12 else 1,
                        ms=time_ms(lambda: K.radix_sort(
                            [kc], counter="radix_sort_rank")),
                        plain_ms=time_ms(lambda: K.radix_sort_plain([kc])),
                        bound=bound(4 * cap * 3, cap),
                        library_ms=time_ms(lambda: torch.sort(
                            kc, stable=True)), case=label)
                    if not ok12:
                        raise AssertionError("radix_sort_rank disagrees")
                else:
                    entries.setdefault("rank_slots", e16)
            entries.setdefault("rank_slots", e16)
            gslot, t_slots = got16[0], cap
        else:
            gslot, t_slots = kc, g_pad
        ext15, n_id, n_raw = [], 0, len(lanes.floats)
        for kind, _lane, which, card_pad in lanes.extremes:
            if kind == "ids":
                ext15.append(("ids", ids_c[n_id], which,
                              card_pad if which == "min" else -1))
                n_id += 1
            else:
                ext15.append(("raw", vals_c[n_raw], which, 0))
                n_raw += 1
        a15 = (gslot, t_slots, cap, parts_c, vals_c[:len(lanes.floats)],
               ext15)
        got15, ref15 = K.slot_tables(*a15), K.slot_tables_plain(*a15)
        int_ok = _equal(got15[0], ref15[0]) and _equal(got15[1], ref15[1]) \
            and all(_equal(a, b) for a, b in zip(got15[3], ref15[3]))
        f_err = float((got15[2] - ref15[2]).abs().max()) \
            if got15[2].numel() else 0.0
        f_ok = bool(((got15[2] - ref15[2]).abs() <= CSUMS_RTOL *
                     ref15[2].abs().clamp_min(1.0)).all())
        n_l = parts_c.shape[0]
        in_bytes = cap * (4 + n_l + 8 * len(lanes.floats) +
                          sum(e[1].element_size() for e in ext15))
        out_bytes = t_slots * (4 + got15[1].element_size() * got15[1].numel()
                               // t_slots + 8 * len(lanes.floats) +
                               sum(t.element_size() for t in got15[3]))
        valid = gslot < t_slots

        def library15():
            g = torch.where(valid, gslot, t_slots).long()
            return torch.zeros(t_slots + 1, dtype=torch.int32,
                               device=gslot.device).index_add_(
                0, g, parts_c[0].int() if n_l else valid.int())

        e15 = dict(max_abs_err=f_err if int_ok else 1.0,
                   ms=time_ms(lambda: K.slot_tables(*a15)),
                   plain_ms=time_ms(lambda: K.slot_tables_plain(*a15),
                                    reps=3),
                   bound=bound(in_bytes + out_bytes, cap * (1 + n_l)),
                   library_ms=time_ms(library15), case=label)
        emit({"phase": "group_compact_check", "case": label,
              "kernel": "slot_tables", "t_slots": t_slots, "cap": cap,
              "layout": "ranked" if ranked else "dense",
              "ints_equal": int_ok, "csums_max_abs_err": f_err,
              "csums_rtol": CSUMS_RTOL,
              **{k: v for k, v in e15.items() if k != "bound"},
              "bound_ms": e15["bound"][0], "bound_by": e15["bound"][1]})
        if not int_ok or not f_ok:
            raise AssertionError(f"slot_tables disagrees on {label}")
        entries.setdefault("slot_tables", e15)
    return entries


def sorted_ssb_segments(table, n_segs: int):
    """The first n_segs SSB segments' rows sorted on d_yearmonthnum (a
    table whose sortedColumn is its time column), built in memory."""
    from pinot_tpu_torch.tools.datagen import SSB_TYPES, \
        make_segment_from_arrays
    from pinot_tpu_torch.common.datatype import DataType
    per = table.segments[0].num_docs
    segs, rows = [], []
    for i in range(n_segs):
        lo, hi = i * per, (i + 1) * per
        order = np.argsort(table.ids["d_yearmonthnum"][lo:hi],
                           kind="stable") + lo
        rows.append(order)
        segs.append(make_segment_from_arrays(
            f"ssb_sorted_{i}", "lineorder",
            {c: (SSB_TYPES[c], table.pools[c], table.ids[c][order])
             for c in table.pools},
            {"lo_supplycost": (DataType.DOUBLE, table.supplycost[order])}))
    return segs, np.concatenate(rows)


def crowded_expected(table, rows) -> dict:
    """{(c_nation, p_mfgr): [revenue, count]} of CROWDED_PQL over `rows`."""
    ids, pools = table.ids, table.pools
    month = int(np.searchsorted(pools["d_yearmonth"], "Dec1997"))
    r = rows[ids["d_yearmonth"][rows] == month]
    nat = ids["c_nation"][r].astype(np.int64)
    mfgr = ids["p_mfgr"][r].astype(np.int64)
    n_m = len(pools["p_mfgr"])
    key = nat * n_m + mfgr
    rev = np.asarray(pools["lo_revenue"], np.float64)[ids["lo_revenue"][r]]
    sums = np.bincount(key, weights=rev)
    counts = np.bincount(key)
    return {(str(pools["c_nation"][k // n_m]), str(pools["p_mfgr"][k % n_m])):
            [float(sums[k]), float(counts[k])]
            for k in np.nonzero(counts)[0]}


def _groups_of(resp) -> dict:
    out = {}
    for fi, agg in enumerate(resp.aggregation_results):
        for g in agg.group_by_result:
            out.setdefault(tuple(str(x) for x in g["group"]), []).append(
                float(g["value"]))
    return out


def run_group_compact(label, on_engine, off_engine, st_engine, cases,
                      check, rtol: float, repeats: int):
    """The end-to-end comparison of one table's filtered group-bys: per
    case (name, pql), per segment (`on_engine`, the planner's default,
    compaction on; `off_engine`, InstancePlanMaker(allow_group_compaction
    =False)) and stacked (`st_engine` with either plan maker): launch
    counts and route counts from 0, one run, checked (check(name,
    response) raises unless it meets the oracle: the first path directly,
    the others where they differ from it beyond `rtol`), the counts read;
    then min(--repeats, GROUP_COMPACT_REPEATS) timed runs, p50 on beside
    off. Returns the compaction-on runs' launch counts and route
    counts."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    on_maker = st_engine.sharded.plan_maker
    off_maker = InstancePlanMaker(allow_group_compaction=False)
    launches = dict.fromkeys(K.launch_counts(), 0)
    routes = collections.Counter()
    for name, pql in cases:
        row = {"phase": "group_compact", "table": label, "case": name}
        first = None
        for path, engine, maker in (
                ("per_segment_on", on_engine, None),
                ("per_segment_off", off_engine, None),
                ("stacked_on", st_engine, on_maker),
                ("stacked_off", st_engine, off_maker)):
            if maker is not None:
                st_engine.sharded.plan_maker = maker
            try:
                K.reset_launch_counts()
                resp = engine.query(pql)
                torch.cuda.synchronize()
                counts = K.launch_counts()
                got_routes = dict(K.group_route_counts)
                if resp.exceptions:
                    raise AssertionError(f"{label} {name} {path}: "
                                         f"{resp.exceptions}")
                # the first path meets the oracle; the others equal it or
                # the oracle judges them too
                if first is None:
                    check(name, resp)
                    first = resp
                elif not same_answer(resp, first, rtol):
                    check(name, resp)
                if path.startswith("stacked") and \
                        engine.last_route != ("stacked", None):
                    raise AssertionError(f"{label} {name} left the stacked "
                                         f"path: {engine.last_route}")
                if path.endswith("_on"):
                    for k, v in counts.items():
                        launches[k] += v
                    routes.update(got_routes)
                elif got_routes:
                    raise AssertionError(f"{label} {name} {path}: "
                                         f"compaction off took {got_routes}")
                ts = []
                for _ in range(min(repeats, GROUP_COMPACT_REPEATS)):
                    t = time.perf_counter()
                    engine.query(pql)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t) * 1e3)
            finally:
                st_engine.sharded.plan_maker = on_maker
            row[f"{path}_p50_ms"] = float(np.median(ts))
            row[f"{path}_routes"] = got_routes
        emit(row)
    emit({"phase": "group_compact_summary", "table": label,
          "routes": dict(routes),
          "launches": {k: v for k, v in launches.items() if v}})
    return launches, routes


# ---------------------------------------------------------------------------
# VECTOR_SIMILARITY: the JAX package's vector rung (tools/vecdata.py)
# ---------------------------------------------------------------------------


def vec_data(base, args):
    """Phase vec_data: draw and seal the vector table with the port's
    SegmentCreator (IVF codebooks trained on the card: K10 and K11, their
    launches counted from 0), load it with from_dirs and put its lanes on
    the card. Returns (engine, draws, launches)."""
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import vecdata
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dirs, draws, secs = vecdata.build_segment_dirs(
        base, args.vec_rows, args.vec_segments, args.vec_dim)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = K.launch_counts()
    if not launches["ivf_assign"] or not launches["ivf_recenter"]:
        raise AssertionError(f"IVF training left the card: {launches}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = QueryEngine.from_dirs(dirs)                  # on the card
    for seg in engine.segments:
        ds = seg.data_source("emb")
        for lane in (ds.device_vec_values, ds.device_ivf_assign,
                     ds.device_ivf_centroids, ds.device_ivf_valid,
                     seg.data_source("rid").device_dict_ids):
            lane()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    emit({"phase": "vec_data", "rows": args.vec_rows,
          "segments": args.vec_segments, "dim": args.vec_dim,
          "centroids_per_segment": vecdata.CENTERS,
          "train_iterations": vecdata.IVF_ITERATIONS,
          "train_sample": vecdata.IVF_SAMPLE,
          "padded_rows_per_segment": engine.segments[0].padded_docs,
          "build_seconds": build_s, "draw_seconds": secs["draw"],
          "seal_seconds": secs["seal"], "train_seconds": secs["train"],
          "load_seconds": load_s,
          "device_table_bytes": sum(s.device_bytes()
                                    for s in engine.segments),
          "disk_bytes": sum(os.path.getsize(os.path.join(d, f))
                            for d in dirs for f in os.listdir(d)),
          "launches": {k: v for k, v in launches.items() if v}})
    return engine, draws, launches


def _query(q, dim: int):
    from pinot_tpu_torch.ops import kernels as K
    qp = np.zeros(dim, np.float32)
    qp[:len(q)] = q
    return qp, np.float32(np.sqrt(K.vec_tree_sum_plain(qp * qp)))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _score_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).abs().nan_to_num(0.0, 0.0, 0.0)
    return float(d.max()) if d.numel() else 0.0


def _topk_equal(got, want) -> bool:
    return all(torch.equal(got[k], want[k]) for k in want) and \
        set(got) == set(want)


def vector_kernel_check(engine, st_engine, q):
    """Phase vector_kernel_check: K8, K6's vector kind, K9 (with K1's
    ivf_probe node), K10 and K11 against their plain versions on segment
    0's lanes, and K8, K6-vector, K9 and K1 over the stack against their
    plain stacked versions and S per-segment launches. Bit-equal: K8's
    scores, K6's docids / scores / count, K9's probe lists, K1's masks;
    K10's assignments wherever the best two distances differ by more than
    1e-3 of the best, its distances within 1e-3 + 1e-4 relative; K11's
    counts equal, its centroids within 1e-5 and byte-identical run to
    run, on the sample's assignments and with every row on one centroid.
    Returns ({kernel: numbers}, {kernel: stacked numbers})."""
    from pinot_tpu_torch.ops import ivf_kernels as IK
    from pinot_tpu_torch.ops import kernels as K
    seg = engine.segments[0]
    P, n = seg.padded_docs, seg.num_docs
    ds = seg.data_source("emb")
    mat, ivfa = ds.device_vec_values(), ds.device_ivf_assign()
    cent, cvalid = ds.device_ivf_centroids(), ds.device_ivf_valid()
    dim, n_cent = mat.shape[1], int(ds.ivf_centroids.shape[0])
    c_pad = cent.shape[0]
    qp, qn = _query(q, dim)
    qt = torch.from_numpy(qp).to(mat.device)
    entries, stacked, report = {}, {}, []

    def record(name, case, equal, **numbers):
        r = {"kernel": name, "case": case, "equal": bool(equal), **numbers}
        report.append(r)
        emit({"phase": "vector_kernel_check", **r})
        if not equal:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {case}: {r}")

    # K8 on segment 0, both metrics
    for metric in ("cosine", "dot"):
        got = K.vector_scores(mat, qp, qn, metric)
        ref = K.vector_scores_plain(mat, qp, qn, metric)
        record("vector_scores", metric, _bits_equal(got, ref),
               max_abs_err=_score_err(got, ref))
    k8_bytes = P * dim * 4 + P * 4
    entries["vector_scores"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: K.vector_scores(mat, qp, qn, "cosine")),
        plain_ms=time_ms(lambda: K.vector_scores_plain(mat, qp, qn,
                                                       "cosine"), reps=3),
        bound=bound(k8_bytes, 4.0 * P * dim),
        library_ms=time_ms(lambda: torch.mv(mat, qt)))

    # K6's vector kind on K8's cosine scores, every valid row matched
    mask = K.filter_mask(P, ("match_all",), {}, [], n, mat.device)
    scores = K.vector_scores(mat, qp, qn, "cosine")
    got = K.vector_topk(scores, mask, 16)
    ref = K.vector_topk_plain(scores, mask, 16)
    record("masked_select_vector", "cosine k=16", _topk_equal(got, ref),
           count=int(got["sel.count"]))
    masked = torch.where(mask.bool(), scores, float("-inf"))
    entries["masked_select_vector"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: K.vector_topk(scores, mask, 16)),
        plain_ms=time_ms(lambda: K.vector_topk_plain(scores, mask, 16),
                         reps=3),
        bound=bound(P + P * 4 + 16 * 8, P), library_ms=time_ms(
            lambda: torch.topk(torch.where(mask.bool(), scores,
                                           float("-inf")), 16)))
    del masked

    # K9 (nprobe 16) and K1's ivf_probe node (its K9 inside)
    for metric in ("cosine", "dot"):
        ids, ok = K.ivf_select_probes(cent, cvalid, qp, qn, metric, 16)
        rids, rok = K.ivf_select_probes_plain(cent, cvalid, qp, qn, metric,
                                              16)
        record("ivf_probe_select", metric,
               torch.equal(ids, rids) and torch.equal(ok, rok),
               live_centroids=int(cvalid.sum()))
    entries["ivf_probe_select"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: K.ivf_select_probes(cent, cvalid, qp, qn,
                                               "cosine", 16)),
        plain_ms=time_ms(lambda: K.ivf_select_probes_plain(
            cent, cvalid, qp, qn, "cosine", 16), reps=3),
        bound=bound(c_pad * dim * 4 + c_pad + 16 * 5, 4.0 * c_pad * dim),
        library_ms=time_ms(lambda: torch.topk(torch.mv(cent, qt), 16)))
    probe = ("pred", "ivf_probe", "emb", "ivf", (16, "cosine"))
    pcols = {"emb.ivfa": ivfa, "emb.ivfc": cent, "emb.ivfv": cvalid}
    got = K.filter_mask(P, probe, pcols, [qp, qn], n)
    ref = K.filter_mask_plain(P, probe, pcols, [qp, qn], n)
    record("filter_mask", "ivf_probe nprobe=16 (with its K9)",
           torch.equal(got, ref), matched=int(ref.sum()),
           ms=time_ms(lambda: K.filter_mask(P, probe, pcols, [qp, qn], n)),
           plain_ms=time_ms(lambda: K.filter_mask_plain(
               P, probe, pcols, [qp, qn], n), reps=3),
           bound_ms=bound(P * ivfa.element_size() + P +
                          c_pad * dim * 4, P * 16)[0])

    # K10 over segment 0's rows against its codebook
    data = mat[:n]
    assign, dist = IK.ivf_assign(data, cent, n, n_cent)
    ref_a, ref_d = IK.ivf_assign_plain(data, cent, n, n_cent)
    d2 = (K.vec_tree_sum_plain(data * data)[:, None] -
          2.0 * (data @ cent[:n_cent].T) +
          K.vec_tree_sum_plain(cent[:n_cent] * cent[:n_cent])[None, :])
    two = torch.topk(d2, 2, dim=1, largest=False).values
    sure = (two[:, 1] - two[:, 0]) > 1e-3 * two[:, 0].abs().clamp_min(1.0)
    del d2, two
    mismatched = int(((assign != ref_a) & sure).sum())
    record("ivf_assign", f"{n} rows x {n_cent} centroids", mismatched == 0 and
           bool(torch.allclose(dist, ref_d, rtol=1e-4, atol=1e-3)),
           mismatched_sure=mismatched, unsure_rows=int((~sure).sum()),
           differ_unsure=int(((assign != ref_a) & ~sure).sum()),
           max_abs_err=float((dist - ref_d).abs().max()))
    flops = 2.0 * n * n_cent * dim
    entries["ivf_assign"] = dict(
        max_abs_err=float((dist - ref_d).abs().max()),
        ms=time_ms(lambda: IK.ivf_assign(data, cent, n, n_cent), reps=5),
        plain_ms=time_ms(lambda: IK.ivf_assign_plain(data, cent, n, n_cent),
                         reps=3),
        bound=bound(n * dim * 4 + n_cent * dim * 4 + n * 8, flops),
        library_ms=time_ms(lambda: torch.cdist(data, cent[:n_cent])
                           .argmin(dim=1), reps=3))

    # K11 on a training sample's shape (its first rows, K10's cells), and
    # with every row on one centroid (the skew a single block per centroid
    # would serialise)
    m = min(65536, n)
    sample = data[:m].contiguous()
    a_s, _ = IK.ivf_assign(sample, cent, m, n_cent)
    a_one = torch.full_like(a_s, n_cent // 2)
    for case, a in ((f"{m} rows x {c_pad} centroids", a_s),
                    (f"{m} rows x {c_pad} centroids, every row on one",
                     a_one)):
        new_c, counts = IK.ivf_recenter(sample, a, m, cent)
        again, _ = IK.ivf_recenter(sample, a, m, cent)
        ref_c, ref_n = IK.ivf_recenter_plain(sample, a, m, cent)
        err = float((new_c - ref_c).abs().max())
        e = dict(
            max_abs_err=err,
            ms=time_ms(lambda: IK.ivf_recenter(sample, a, m, cent)),
            plain_ms=time_ms(lambda: IK.ivf_recenter_plain(sample, a, m,
                                                           cent), reps=3),
            bound=bound(m * dim * 4 + m * 4 + 2 * c_pad * dim * 4 +
                        c_pad * 4, 1.0 * m * dim),
            library_ms=time_ms(lambda: torch.zeros_like(cent).index_add_(
                0, a.long(), sample)))
        record("ivf_recenter", case,
               torch.equal(counts, ref_n) and _bits_equal(new_c, again) and
               bool(torch.allclose(new_c, ref_c, rtol=1e-5, atol=1e-5)),
               run_to_run_bytes_equal=_bits_equal(new_c, again),
               launch_us=launch_breakdown(
                   lambda: IK.ivf_recenter(sample, a, m, cent)),
               **{k: v for k, v in e.items() if k != "bound"},
               bound_ms=e["bound"][0], bound_by=e["bound"][1])
        entries.setdefault("ivf_recenter", e)

    # the stack: one launch over all S segments against S launches
    stack = st_engine.sharded.stack_for(st_engine.segments)
    S = stack.n_real
    keys = [("emb", "vec"), ("emb", "ivfa"), ("emb", "ivfc"), ("emb", "ivfv")]
    flat = K.flat_lanes(stack.gather(keys), S, P)
    segs, docs = stack.segments, stack.device_num_docs()
    per = [{k: getattr(sg.data_source("emb"), f)() for k, f in
            (("vec", "device_vec_values"), ("ivfa", "device_ivf_assign"),
             ("ivfc", "device_ivf_centroids"), ("ivfv", "device_ivf_valid"))}
           for sg in segs]
    svec = flat["emb.vec"]
    got = K.vector_scores(svec, qp, qn, "cosine")
    seq = torch.cat([K.vector_scores(p["vec"], qp, qn, "cosine")
                     for p in per])
    equal = _bits_equal(got, K.vector_scores_plain(svec, qp, qn, "cosine")) \
        and _bits_equal(got, seq)
    b = bound(S * P * dim * 4 + S * P * 4, 4.0 * S * P * dim)
    st = dict(ms=time_ms(lambda: K.vector_scores(svec, qp, qn, "cosine")),
              s_sequential_ms=time_ms(lambda: [K.vector_scores(
                  p["vec"], qp, qn, "cosine") for p in per], spins=S),
              bound_ms=b[0])
    record("vector_scores", f"stacked S={S}", equal, **st)
    stacked["vector_scores"] = st
    smask, _matched = K.filter_mask_stacked(P, S, ("match_all",), {}, [],
                                            docs, mat.device)
    got = K.vector_topk(got, smask, 16, n_segs=S)
    equal = _topk_equal(got, K.vector_topk_plain(seq, smask, 16, n_segs=S))
    seg_masks = [smask[i * P:(i + 1) * P] for i in range(S)]
    seg_scores = [seq[i * P:(i + 1) * P] for i in range(S)]
    equal = equal and all(
        torch.equal(got["sel.docids"][i],
                    K.vector_topk(seg_scores[i], seg_masks[i], 16)
                    ["sel.docids"]) for i in range(S))
    st = dict(ms=time_ms(lambda: K.vector_topk(seq, smask, 16, n_segs=S)),
              s_sequential_ms=time_ms(lambda: [
                  K.vector_topk(seg_scores[i], seg_masks[i], 16)
                  for i in range(S)], spins=S),
              bound_ms=bound(S * P * 5 + S * 16 * 8, S * P)[0])
    record("masked_select_vector", f"stacked S={S}", equal, **st)
    stacked["masked_select_vector"] = st
    scent, scv = flat["emb.ivfc"], flat["emb.ivfv"]
    ids, ok = K.ivf_select_probes(scent, scv, qp, qn, "cosine", 16)
    rids, rok = K.ivf_select_probes_plain(scent, scv, qp, qn, "cosine", 16)
    equal = torch.equal(ids, rids) and torch.equal(ok, rok) and all(
        torch.equal(ids[i], K.ivf_select_probes(
            p["ivfc"], p["ivfv"], qp, qn, "cosine", 16)[0])
        for i, p in enumerate(per))
    st = dict(ms=time_ms(lambda: K.ivf_select_probes(scent, scv, qp, qn,
                                                     "cosine", 16)),
              s_sequential_ms=time_ms(lambda: [K.ivf_select_probes(
                  p["ivfc"], p["ivfv"], qp, qn, "cosine", 16) for p in per],
                  spins=S),
              bound_ms=bound(S * (c_pad * dim * 4 + c_pad + 80),
                             4.0 * S * c_pad * dim)[0])
    record("ivf_probe_select", f"stacked S={S}", equal, **st)
    stacked["ivf_probe_select"] = st
    got_m, got_n = K.filter_mask_stacked(P, S, probe, flat, [qp, qn], docs)
    ref_m, ref_n = K.filter_mask_stacked_plain(P, S, probe, flat, [qp, qn],
                                               docs)
    record("filter_mask", f"ivf_probe stacked S={S}",
           torch.equal(got_m, ref_m) and torch.equal(got_n, ref_n),
           matched=int(ref_n.sum()))
    for name in ("ivf_assign", "ivf_recenter"):
        stacked[name] = dict(ms=None, s_sequential_ms=None, bound_ms=None)
    return entries, stacked


def _vec_pql(q, metric: str, nprobe: int, where: str = "") -> str:
    qs = ", ".join(repr(float(x)) for x in q)
    clause = f", nprobe={nprobe}" if nprobe else ""
    from pinot_tpu_torch.tools import vecdata
    return (f"SELECT rid, VECTOR_SIMILARITY(emb, [{qs}], {vecdata.K}, "
            f"'{metric}'{clause}) FROM {vecdata.TABLE} {where}").strip()


def run_vector(engine, st_engine, queries, args, repeats: int):
    """Phase vector, per segment and stacked: counts set to 0, each query
    vector under COSINE and DOT, exact and at nprobe 1, 4 and 16, and one
    filtered exact query, run once; the counts read (K1, K8, K9 and K6's
    vector kind must have launched) and the routes; every exact answer
    equal to the chunked numpy oracle bit for bit (docids, segments,
    scores), the stacked answers equal to the per-segment ones; per rung
    the recall@10 against the exact answer and the share of rows scanned
    (numDocsScanned); then the timed repeats (p50 per rung). The gate of
    scripts/vec_ann_bench.py: some nprobe rung reaches recall@10 >= 0.95
    (mean over the queries) while scanning < 15% of the rows. Returns the
    launch counts per route, the oracle and its exact answers."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import vecdata
    rows = sum(s.num_docs for s in engine.segments)
    t0 = time.perf_counter()
    oracle = vecdata.VecOracle([(s.segment_name,
                                 s.data_source("emb").vec_values)
                                for s in engine.segments])
    cut = rows * 3 // 10                               # WHERE rid < cut
    rid_masks = [s.data_source("rid").dictionary.values[
        s.data_source("rid").dict_ids] < cut for s in engine.segments]
    exact = {}
    for qi, q in enumerate(queries):
        for metric in ("COSINE", "DOT"):
            exact[(qi, metric)] = oracle.topk(q, vecdata.K, metric)
    exact_filtered = oracle.topk(queries[0], vecdata.K, "COSINE", rid_masks)
    oracle_s = time.perf_counter() - t0
    rungs = [("exact", 0)] + [(f"nprobe={p}", p) for p in vecdata.NPROBES]
    launches_by_route, answers = {}, {}
    for route, eng in (("per_segment", engine), ("stacked", st_engine)):
        K.reset_launch_counts()
        eng.executor.reset_path_counts()
        eng.route_counts.clear()
        runs = {}
        for qi, q in enumerate(queries):
            for metric in ("COSINE", "DOT"):
                for rung, nprobe in rungs:
                    t = time.perf_counter()
                    resp = eng.query(_vec_pql(q, metric, nprobe))
                    torch.cuda.synchronize()
                    runs[(qi, metric, rung)] = (
                        resp, (time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        fresp = eng.query(_vec_pql(queries[0], "COSINE", 0,
                                   f"WHERE rid < {cut}"))
        torch.cuda.synchronize()
        filtered_ms = (time.perf_counter() - t) * 1e3
        launches = K.launch_counts()
        launches_by_route[route] = launches
        if route == "stacked":
            routes = dict(eng.route_counts)
            paths = dict(eng.sharded.plan_maker.path_counts)
            if routes != {"stacked": len(runs) + 1}:
                raise AssertionError(f"vector queries left the stacked "
                                     f"path: {routes}")
        else:
            routes = dict(eng.executor.path_counts)
            paths = dict(eng.executor.plan_maker.path_counts)
        for name in ("filter_mask", "vector_scores", "masked_select_vector",
                     "ivf_probe_select"):
            if not launches[name]:
                raise AssertionError(f"{name} never launched on the {route} "
                                     f"vector path: {launches}")
        got_rows = {}
        for key, (resp, _ms) in runs.items():
            if resp.exceptions:
                raise AssertionError(f"{route} {key}: {resp.exceptions}")
            got_rows[key] = [(int(r[1]), r[2], float(r[3]))
                             for r in resp.selection_results.results]
        for (qi, metric), want in exact.items():
            if got_rows[(qi, metric, "exact")] != want:
                raise AssertionError(f"{route}: exact q{qi} {metric} differs "
                                     "from the oracle")
        fgot = [(int(r[1]), r[2], float(r[3]))
                for r in fresp.selection_results.results]
        if fgot != exact_filtered:
            raise AssertionError(f"{route}: filtered query differs from the "
                                 "oracle")
        answers[route] = got_rows
        stats = {}
        for rung, nprobe in rungs:
            for metric in ("COSINE", "DOT"):
                rec, scan = [], []
                for qi in range(len(queries)):
                    resp, _ms = runs[(qi, metric, rung)]
                    rec.append(vecdata.recall(
                        [r[:2] for r in got_rows[(qi, metric, rung)]],
                        [r[:2] for r in exact[(qi, metric)]]))
                    scan.append(resp.num_docs_scanned / rows)
                stats[f"{rung} {metric}"] = {
                    "recall_at_10": float(np.mean(rec)),
                    "recall_min": float(min(rec)),
                    "scanned_share": float(np.mean(scan))}
        firsts = {rung: float(np.median([ms for (qi, m, r), (_resp, ms)
                                         in runs.items() if r == rung]))
                  for rung, _n in rungs}
        p50 = {}
        for rung, nprobe in rungs:
            ts = []
            for _ in range(repeats):
                for qi, q in enumerate(queries):
                    for metric in ("COSINE", "DOT"):
                        pql = _vec_pql(q, metric, nprobe)
                        t = time.perf_counter()
                        eng.query(pql)
                        torch.cuda.synchronize()
                        ts.append((time.perf_counter() - t) * 1e3)
            p50[rung] = float(np.median(ts))
        emit({"phase": "vector", "route": route, "rows": rows,
              "queries": len(queries), "metrics": ["COSINE", "DOT"],
              "exact_equal_oracle": True, "p50_ms": p50,
              "first_run_median_ms": firsts, "rungs": stats,
              "filtered": {"where": f"rid < {cut}", "ms": filtered_ms,
                           "scanned_share": fresp.num_docs_scanned / rows,
                           "equal_oracle": True},
              "routes": routes, "ivf_paths": paths,
              "oracle_seconds": oracle_s,
              "launches": {k: v for k, v in launches.items() if v}})
        if route == "stacked":
            if got_rows != answers["per_segment"]:
                raise AssertionError("stacked vector answers differ from "
                                     "the per-segment ones")
        gate = [r for r, s in stats.items() if r.endswith("COSINE") and
                r != "exact COSINE" and s["recall_at_10"] >= VEC_RECALL_GATE
                and s["scanned_share"] < VEC_SCAN_GATE]
        if not gate:
            raise AssertionError(f"{route}: no nprobe rung reaches recall@10 "
                                 f">= {VEC_RECALL_GATE} scanning < "
                                 f"{VEC_SCAN_GATE} of the rows: {stats}")
    return launches_by_route, oracle, exact


# ---------------------------------------------------------------------------
# Cross-query batches: execute_batch, one launch per kernel for <= 8 members
# ---------------------------------------------------------------------------

BATCH_SIZES = (2, 5, 8)


def _flat(out) -> list:
    """A kernel's outputs as a flat list of tensors (a dict's in key
    order)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [t for o in out for t in _flat(o)]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def batch_case(name, case, batched, plain, single, nbytes, ops, rtol=None,
               singles_of=None, expect=None, library=None,
               sizes=BATCH_SIZES):
    """The batched form of kernel `name` on one case at each B of
    `sizes`: batched(B), plain(B) and single(b) give outputs (tensors,
    tuples or dicts). Held to its plain version, bit for bit (the outputs
    at the indices of `rtol`, float64 block sums, within that relative
    tolerance), and bit for bit to B single launches (the batched outputs
    at `singles_of`, all by default); launched once per call (`expect`:
    the launches one call makes, {name_batched: 1} by default). Timed at
    B = 8 with the L2 flushed: the batched launch, 8 single launches, the
    plain version and `library` beside the bound of nbytes(8) bytes and
    ops(8) operations. Returns its report."""
    from pinot_tpu_torch.ops import kernels as K
    expect = expect or {f"{name}_batched": 1}
    rtol = rtol or {}
    err = 0.0
    for B in sizes:
        K.reset_launch_counts()
        got = _flat(batched(B))
        torch.cuda.synchronize()
        launched = {k: v for k, v in K.launch_counts().items() if v}
        if launched != expect:
            raise AssertionError(f"{name} {case} B={B}: launches {launched}"
                                 f", expected {expect}")
        ref = _flat(plain(B))
        for i, (g, r) in enumerate(zip(got, ref)):
            if i in rtol:
                d = (g - r).abs()
                err = max(err, float(d.max()))
                ok = bool((d <= rtol[i] * r.abs().clamp_min(1.0)).all())
            else:
                ok = _same_bits(g, r)
            if not ok:
                raise AssertionError(f"{name} {case} B={B}: output {i} "
                                     "differs from the plain version")
        singles = [_flat(single(b)) for b in range(B)]
        for j, i in enumerate(singles_of or range(len(got))):
            if not _same_bits(got[i], torch.stack([s[j] for s in singles])):
                raise AssertionError(f"{name} {case} B={B}: output {i} "
                                     f"differs from {B} single launches")
    b = bound(nbytes(8), ops(8))
    report = {"kernel": f"{name}_batched", "case": case,
              "batch_sizes": list(sizes), "max_abs_err": err,
              "plain_equal": True, "singles_bit_equal": True,
              "ms": time_ms(lambda: batched(8)),
              "b_single_ms": time_ms(lambda: [single(i) for i in range(8)],
                                     spins=8),
              "plain_ms": time_ms(lambda: plain(8), reps=3, warmup=1),
              "library_ms": time_ms(library) if library else None,
              "bound_ms": b[0], "bound_by": b[1]}
    emit({"phase": "batch_kernel_check", **report})
    return report


def _family_operands(seg, pqls):
    """(filter spec, lanes, the members' filter params) of same-shape
    plans on one segment."""
    plans = [plan_operands(seg, pql) for pql in pqls]
    spec = plans[0][0].filter_spec
    if any(p.filter_spec != spec for p, _c in plans):
        raise AssertionError(f"the family's filters differ: {pqls[0]}")
    return spec, plans[0][1], [list(p.params) for p, _c in plans]


def _filter_case(seg, case, pqls, expect=None, live=None):
    """batch_case for K1 over a family's filter (ANDed with the vdoc node
    over the liveness lane `live`, where given); returns (report, [8, P]
    masks)."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.query.plan import VALID_DOC_COLUMN, \
        with_valid_doc_mask
    P, n = seg.padded_docs, seg.num_docs
    spec, cols, params = _family_operands(seg, pqls)
    if live is not None:
        spec = with_valid_doc_mask(spec)
        cols = dict(cols, **{f"{VALID_DOC_COLUMN}.vdoc": live})
    keys = K.filter_lane_keys(spec)
    lane_bytes = sum(cols[k].numel() * cols[k].element_size() for k in keys)
    widths = sum(cols[k].numel() // P for k in keys)
    r = batch_case(
        "filter_mask", case,
        lambda B: K.filter_mask_batched(P, spec, cols, params[:B], n),
        lambda B: K.filter_mask_batched_plain(P, spec, cols, params[:B], n),
        lambda b: K.filter_mask(P, spec, cols, params[b], n),
        lambda B: lane_bytes + B * P + 4 * B,
        lambda B: B * P * 2 * widths, singles_of=(0,), expect=expect)
    return r, K.filter_mask_batched(P, spec, cols, params, n)[0]


def batch_kernel_check_ssb(seg):
    """Phase batch_kernel_check on an SSB segment: K1 (dictId leaves) and
    K2 over the Q1.1 family of the batch phase."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools.ssb import Q1_TEMPLATES, q1_batches
    P = seg.padded_docs
    pqls = [Q1_TEMPLATES["q1.1"].format(**lits)
            for lits in q1_batches()["q1.1"]]
    entries = {}
    entries["filter_mask"], masks = _filter_case(seg, "ssb q1.1 family",
                                                 pqls)
    # K1's vdoc node: the family over one shared liveness lane
    entries["filter_mask[vdoc]"], _m = _filter_case(
        seg, "ssb q1.1 family with a bitmap", pqls,
        expect={"filter_mask_batched": 1, "filter_mask_batched[vdoc]": 1},
        live=liveness_lane(P, seg.num_docs, 2))
    parts = [plan_operands(seg, pqls[0])[1]["lo_revenue.parts"]]
    L = parts[0].shape[0]
    union, matched = int(masks.any(0).sum()), int(masks.sum())
    entries["masked_part_sums"] = batch_case(
        "masked_part_sums", "ssb q1.1 family, lo_revenue",
        lambda B: K.masked_part_sums_batched(masks[:B], parts),
        lambda B: K.masked_part_sums_batched_plain(masks[:B], parts),
        lambda b: K.masked_part_sums(masks[b], parts),
        lambda B: B * P + union * L + 4 * B * (L + 1),
        lambda B: B * P + matched * L)
    return entries


#: the baseballStats families of the batched K1 cases (8 members each)
BB_BATCH_FILTERS = {
    "raw": ["SELECT COUNT(*) FROM baseballStats WHERE salary > %d AND "
            "runs < %d" % (s, r) for s, r in zip(
                range(100000, 900000, 100000), range(40, 140, 12))],
    "mv": ["SELECT COUNT(*) FROM baseballStats WHERE position = '%s' OR "
           "position NOT IN ('P', 'C')" % p for p in
           ("1B", "2B", "3B", "SS", "LF", "CF", "RF", "DH")],
    "dictId": ["SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE runs > "
               "'%d'" % v for v in (10, 25, 40, 60, 75, 90, 110, 130)],
}


def batch_kernel_check_bb(seg):
    """Phase batch_kernel_check on a baseballStats segment: K1 (raw, MV
    and dictId programs), and over the dictId family's masks K2 (runs,
    hits), K4 (teamID ids, position entries), K5 (salary with block sums,
    runs ids, position entries), K6 (each kind of SELECT_PQLS) and K7
    (playerName)."""
    from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M
    from pinot_tpu_torch.ops import kernels as K
    P = seg.padded_docs
    entries = {}
    for case in ("raw", "mv"):
        _filter_case(seg, f"baseball {case} family",
                     BB_BATCH_FILTERS[case])
    _r, masks = _filter_case(seg, "baseball dictId family",
                             BB_BATCH_FILTERS["dictId"])
    # K1's vdoc node on a baseballStats filter (one member)
    plan, cols = plan_operands(seg, BB_AGG_PQL)
    vdoc_check(seg, plan, cols, "baseball yearID >= 2000 with a bitmap", 4)
    union = masks.any(0)
    n_union, matched = int(union.sum()), int(masks.sum())
    cols = plan_operands(seg, BB_AGG_PQL)[1]
    parts = [cols["runs.parts"], cols["hits.parts"]]
    L = sum(p.shape[0] for p in parts)
    batch_case("masked_part_sums", "baseball runs, hits",
               lambda B: K.masked_part_sums_batched(masks[:B], parts),
               lambda B: K.masked_part_sums_batched_plain(masks[:B], parts),
               lambda b: K.masked_part_sums(masks[b], parts),
               lambda B: B * P + n_union * L + 4 * B * (L + 1),
               lambda B: B * P + matched * L)

    ds = seg.data_source("teamID")
    ids = ds.device_dict_ids()
    card_pad = K.pow2_bucket(ds.metadata.cardinality + 1)
    entries["masked_histogram"] = batch_case(
        "masked_histogram", "baseball teamID",
        lambda B: K.masked_histogram_batched(masks[:B], ids, card_pad),
        lambda B: K.masked_histogram_batched_plain(masks[:B], ids, card_pad),
        lambda b: K.masked_histogram(masks[b], ids, card_pad),
        lambda B: B * P + n_union * ids.element_size() + 4 * B * card_pad,
        lambda B: matched)
    pos, pcard = mv_lanes(seg)["position"]
    ppad = K.pow2_bucket(pcard + 1)
    W = pos.shape[1]
    batch_case(
        "masked_histogram", "baseball MV position",
        lambda B: K.masked_entry_histogram_batched(masks[:B], pos, ppad,
                                                   pcard),
        lambda B: K.masked_entry_histogram_batched_plain(masks[:B], pos,
                                                         ppad, pcard),
        lambda b: K.masked_entry_histogram(masks[b], pos, ppad, pcard),
        lambda B: B * P + n_union * W * pos.element_size() + 4 * B * ppad,
        lambda B: matched * W)

    salary = seg.data_source("salary").device_raw_values()
    runs = seg.data_source("runs")
    for case, kind, lane, cp, want_sum, card in (
            ("salary", "raw", salary, 0, True, None),
            ("runs ids", "ids", runs.device_dict_ids(),
             K.pow2_bucket(runs.metadata.cardinality + 1), False, None),
            ("MV position", "ids", pos, ppad, False, pcard)):
        width = lane.numel() // P
        out_bytes = (P // K.BLOCK) * 8 * want_sum + 24
        r = batch_case(
            "masked_reduce", f"baseball {case}",
            lambda B: K.masked_reduce_batched(masks[:B], lane, kind, cp,
                                              want_sum, card),
            lambda B: K.masked_reduce_batched_plain(masks[:B], lane, kind,
                                                    cp, want_sum, card),
            lambda b: K.masked_reduce(masks[b], lane, kind, cp, want_sum,
                                      card),
            lambda B: B * P + n_union * width * lane.element_size() +
            B * out_bytes,
            lambda B: matched * width * (3 if want_sum else 2),
            rtol={3: CSUMS_RTOL} if want_sum else None)
        if case == "salary":
            entries["masked_reduce"] = r

    for case, pql in SELECT_PQLS.items():
        plan, scols = plan_operands(seg, pql)
        spec = plan.select_spec
        if case == "ordertk salary":
            spec = (spec[0], 2048, spec[2], spec[3])
        key_bytes = sum(scols[K.gather_lane_key(c, s)].element_size()
                        for c, _asc, _cp, s in spec[2])
        row_bytes = sum(scols[K.gather_lane_key(c, s)][0].numel() *
                        scols[K.gather_lane_key(c, s)].element_size()
                        for c, s in spec[3])
        k = spec[1]
        r = batch_case(
            "masked_select", f"baseball {case}, k={k}",
            lambda B: K.masked_select_batched(spec, scols, masks[:B]),
            lambda B: K.selection_outputs_batched_plain(spec, scols,
                                                        masks[:B]),
            lambda b: K.masked_select(spec, scols, masks[b]),
            lambda B: B * P + n_union * key_bytes +
            B * (k * (4 + row_bytes) + 4),
            lambda B: 0)
        if case == "ordertk salary":
            entries["masked_select"] = r

    m = 1 << DEFAULT_LOG2M
    pn = seg.data_source("playerName")
    pn_pad = K.pow2_bucket(pn.metadata.cardinality + 1)
    hists = K.masked_histogram_batched(masks, pn.device_dict_ids(), pn_pad)
    idx, rank = pn.device_hll_idx(), pn.device_hll_rank()
    entries["hll_registers"] = batch_case(
        "hll_registers", "baseball playerName",
        lambda B: K.hll_registers_batched(hists[:B], idx, rank, m),
        lambda B: K.hll_registers_batched_plain(hists[:B], idx, rank, m),
        lambda b: K.hll_registers(hists[b], idx, rank, m),
        lambda B: 4 * B * pn_pad + 8 * pn_pad + 4 * B * m,
        lambda B: B * pn_pad)
    return entries


def batch_kernel_check_vec(seg, queries):
    """Phase batch_kernel_check on a vector segment, 8 query vectors: K8
    under both metrics (beside torch.mm of the 8 queries), K9 at nprobe 4
    and 16, K1's ivf_probe node (K9 in front) and K6's vector kind over
    the 8 members' scores and probe masks."""
    from pinot_tpu_torch.ops import kernels as K
    P, n = seg.padded_docs, seg.num_docs
    ds = seg.data_source("emb")
    mat = ds.device_vec_values()
    cent, cvalid = ds.device_ivf_centroids(), ds.device_ivf_valid()
    dim = mat.shape[1]
    qn = [_query(q, dim) for q in queries]
    qs, norms = [q for q, _n in qn], [nm for _q, nm in qn]
    qmat = torch.from_numpy(np.stack(qs)).to(mat.device)
    entries = {}
    for metric in ("cosine", "dot"):
        r = batch_case(
            "vector_scores", f"vecbench {metric}",
            lambda B: K.vector_scores_batched(mat, qs[:B], norms[:B],
                                              metric),
            lambda B: K.vector_scores_batched_plain(mat, qs[:B], norms[:B],
                                                    metric),
            lambda b: K.vector_scores(mat, qs[b], norms[b], metric),
            lambda B: mat.numel() * 4 + B * P * 4 + B * dim * 4,
            lambda B: (2 * B + 2 * (metric == "cosine")) * P * dim,
            library=lambda: torch.mm(mat, qmat.T))
        if metric == "cosine":
            entries["vector_scores"] = r
    c_pad = cent.shape[0]
    for nprobe in (4, 16):
        r = batch_case(
            "ivf_probe_select", f"vecbench nprobe={nprobe}",
            lambda B: K.ivf_select_probes_batched(cent, cvalid, qs[:B],
                                                  norms[:B], "cosine",
                                                  nprobe),
            lambda B: K.ivf_select_probes_batched_plain(
                cent, cvalid, qs[:B], norms[:B], "cosine", nprobe),
            lambda b: K.ivf_select_probes(cent, cvalid, qs[b], norms[b],
                                          "cosine", nprobe),
            lambda B: cent.numel() * 4 + c_pad + B * dim * 4 +
            5 * B * nprobe,
            lambda B: B * (2 * c_pad * dim + c_pad * c_pad))
        if nprobe == 16:
            entries["ivf_probe_select"] = r
    spec = ("pred", "ivf_probe", "emb", "ivf", (16, "cosine"))
    cols = {"emb.ivfa": ds.device_ivf_assign(), "emb.ivfc": cent,
            "emb.ivfv": cvalid}
    params = [[q, nm] for q, nm in qn]
    assign = cols["emb.ivfa"]
    batch_case(
        "filter_mask", "vecbench ivf_probe nprobe=16",
        lambda B: K.filter_mask_batched(P, spec, cols, params[:B], n),
        lambda B: K.filter_mask_batched_plain(P, spec, cols, params[:B], n),
        lambda b: K.filter_mask(P, spec, cols, params[b], n),
        lambda B: assign.numel() * assign.element_size() + B * P + 4 * B,
        lambda B: B * P * 2 * 16, singles_of=(0,),
        expect={"filter_mask_batched": 1, "ivf_probe_select_batched": 1})
    masks = K.filter_mask_batched(P, spec, cols, params, n)[0]
    scores = K.vector_scores_batched(mat, qs, norms, "cosine")
    rid = {"rid.ids": seg.data_source("rid").device_dict_ids()}
    gather = (("rid", "sv"),)
    union = int(masks.any(0).sum())
    entries["masked_select_vector"] = batch_case(
        "masked_select_vector", "vecbench cosine top 10 of the probed rows",
        lambda B: K.vector_topk_batched(scores[:B], masks[:B], 10, rid,
                                        gather),
        lambda B: K.vector_topk_batched_plain(scores[:B], masks[:B], 10,
                                              rid, gather),
        lambda b: K.vector_topk(scores[b], masks[b], 10, rid, gather),
        lambda B: B * P + union * 4 * B + B * 10 * 12,
        lambda B: 0)
    return entries


def _member_rows(resp):
    """A response's rows or values, and its scan statistics."""
    if resp.selection_results is not None:
        rows = resp.selection_results.results
    else:
        rows = [(a.value, a.group_by_result) for a in
                resp.aggregation_results]
    return rows, (resp.num_docs_scanned, resp.num_segments_processed,
                  resp.num_segments_matched, resp.total_docs)


def _batched_name(name: str) -> str:
    """A launch count's name under the batched kernel: filter_mask →
    filter_mask_batched, filter_mask[vdoc] → filter_mask_batched[vdoc]."""
    base, bracket, node = name.partition("[")
    return f"{base}_batched{bracket}{node}"


def run_batch(table, engine, families, check, repeats: int):
    """Phase batch on one table: for each family of PQLs (at most 8
    same-shape members, or a "mixed" family), launch counts set to 0,
    engine.executor.execute_batch over the engine's segments, each
    member's block reduced by the engine's reducer; every member's
    answer must equal its own engine.query and the oracle (check(family,
    i, response)); and, but in a mixed family, each kernel the plan uses
    launched once per segment per batch of <= 8 members: one member's
    sequential launches, under the batched names. Then the p50 of
    `repeats` batched runs against the sum of the members' sequential
    p50s. Returns the launches of the batched runs."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.plan import batch_signature, \
        preprocess_request
    total = dict.fromkeys(K.launch_counts(), 0)
    for fam, pqls in families.items():
        reqs = [preprocess_request(engine.segments, engine.optimizer
                                   .optimize(compile_pql(p))) for p in pqls]

        def batch():
            blocks = engine.executor.execute_batch(reqs, engine.segments)
            out = [engine.reducer.reduce(r, [b])
                   for r, b in zip(reqs, blocks)]
            torch.cuda.synchronize()
            return out

        K.reset_launch_counts()
        engine.executor.reset_path_counts()
        t = time.perf_counter()
        resps = batch()
        first_ms = (time.perf_counter() - t) * 1e3
        launches = K.launch_counts()
        paths = dict(engine.executor.path_counts)
        for k, v in launches.items():
            total[k] += v
        K.reset_launch_counts()
        engine.executor.reset_path_counts()
        seq = [engine.query(p) for p in pqls]
        torch.cuda.synchronize()
        seq_launches = K.launch_counts()
        seq_scans = engine.executor.path_counts["scan"]
        for i, (pql, got, want) in enumerate(zip(pqls, resps, seq)):
            if got.exceptions or want.exceptions:
                raise AssertionError(f"{table} {fam} {i}: "
                                     f"{got.exceptions or want.exceptions}")
            if _member_rows(got) != _member_rows(want):
                raise AssertionError(f"{table} {fam} member {i} differs "
                                     f"from its own query: {pql[:120]}")
            check(fam, i, got)
        if fam != "mixed":
            # on each segment, t >= 2 members whose plans share a compiled
            # signature launch each of one plan's kernels once per chunk of
            # <= 8; a plan of its own runs alone (the executor's grouping,
            # its plans made again here)
            chunks = alone = 0
            for seg in engine.segments:
                sigs = collections.Counter(
                    batch_signature(engine.executor.plan_maker
                                    .make_segment_plan(seg, r))
                    for r in reqs if any(s is seg for s in
                                         engine.executor.pruner.prune(
                                             engine.segments, r)))
                chunks += sum(-(-t // K.MAX_BATCH) for t in sigs.values()
                              if t > 1)
                alone += sum(t == 1 for t in sigs.values())
            want = {}
            for k, v in seq_launches.items():
                if v:
                    per_plan, rest = divmod(v, seq_scans)
                    if rest:
                        raise AssertionError(f"{table} {fam}: {k} launched "
                                             f"{v} times over {seq_scans} "
                                             "plans")
                    if chunks:
                        want[_batched_name(k)] = per_plan * chunks
                    if alone:
                        want[k] = per_plan * alone
            got_l = {k: v for k, v in launches.items() if v}
            if got_l != want:
                raise AssertionError(f"{table} {fam}: batched launches "
                                     f"{got_l}, expected {want} (the "
                                     f"members' own: {seq_launches})")
        ts = []
        for _ in range(repeats):
            t = time.perf_counter()
            batch()
            ts.append((time.perf_counter() - t) * 1e3)
        seq_p50 = []
        for pql in pqls:
            st = []
            for _ in range(repeats):
                t = time.perf_counter()
                engine.query(pql)
                torch.cuda.synchronize()
                st.append((time.perf_counter() - t) * 1e3)
            seq_p50.append(float(np.median(st)))
        emit({"phase": "batch", "table": table, "family": fam,
              "members": len(pqls), "check": "pass",
              "first_ms": first_ms, "p50_ms": float(np.median(ts)),
              "sequential_p50_sum_ms": float(np.sum(seq_p50)),
              "sequential_p50_ms": seq_p50, "paths": paths,
              "launches": {k: v for k, v in launches.items() if v}})
    return total


def ssb_batch_families(table):
    """The SSB batch families (tools/ssb.py:q1_batches) and their
    oracle."""
    from pinot_tpu_torch.tools.ssb import Q1_TEMPLATES, canon_response, \
        check, q1_batches, q1_revenue
    lits = q1_batches()
    families = {f: [Q1_TEMPLATES[f].format(**x) for x in ls]
                for f, ls in lits.items()}

    def check_member(fam, i, resp):
        check(fam, canon_response(fam, resp),
              q1_revenue(table.pools, table.ids, fam, lits[fam][i]))
    return families, check_member


def vec_batch_families(engine, queries, oracle, exact, rows):
    """The vector batch families: the 8 query vectors under COSINE and
    DOT, exact and at each nprobe, and queries[0] filtered at rid < 10,
    20 and 30% of the rows; exact members are checked against the oracle
    bit for bit (the probed ones against their own queries only, which
    run_batch does)."""
    from pinot_tpu_torch.tools import vecdata
    # the oracle keeps the last query's dot trees: queries[0] (run_vector's
    # last) first, then each new query under both metrics
    cuts = [rows * p // 10 for p in (1, 2, 3)]
    families = {"COSINE exact filtered": [
        _vec_pql(queries[0], "COSINE", 0, f"WHERE rid < {c}") for c in cuts]}
    want = {"COSINE exact filtered": [
        oracle.topk(queries[0], vecdata.K, "COSINE", [
            s.data_source("rid").dictionary.values[
                s.data_source("rid").dict_ids] < c for s in engine.segments])
        for c in cuts]}
    exact = dict(exact)
    for qi, q in enumerate(queries):
        for metric in ("COSINE", "DOT"):
            if (qi, metric) not in exact:
                exact[(qi, metric)] = oracle.topk(q, vecdata.K, metric)
    for metric in ("COSINE", "DOT"):
        for nprobe in (0,) + vecdata.NPROBES:
            fam = f"{metric} {'exact' if not nprobe else f'nprobe={nprobe}'}"
            families[fam] = [_vec_pql(q, metric, nprobe) for q in queries]
            if not nprobe:
                want[fam] = [exact[(qi, metric)]
                             for qi in range(len(queries))]

    def check_member(fam, i, resp):
        if fam in want:
            got = [(int(r[1]), r[2], float(r[3]))
                   for r in resp.selection_results.results]
            if got != want[fam][i]:
                raise AssertionError(f"vector batch {fam} member {i} "
                                     "differs from the oracle")
    return families, check_member


# ---------------------------------------------------------------------------
# Realtime upserts: consuming segments and validDocIds (K1's vdoc node)
# ---------------------------------------------------------------------------

#: the upsert table's primary key: 997 x 30 x 16 x 2 = 957,120 keys
RT_PK = ("playerName", "yearID", "teamID", "league")
#: Apache Pinot's StreamConfig.DEFAULT_FLUSH_THRESHOLD_ROWS
RT_FLUSH_ROWS = 5_000_000
#: sealed segments of the realtime configuration (PERF.md §4: 3 x
#: 5,000,000 rows); --rt-sealed below it is a depth cut that the timing
#: line names
RT_SEALED_FULL = 2
#: the sealed segments a run ingests by default: one, a depth cut, so
#: that the whole script stays inside its time limit with the phases of
#: the compacted group-by
RT_SEALED_DEFAULT = 1
#: timed runs a realtime family's p50 takes by default: 3, not --repeats,
#: a cut the timing line names (the consuming segment's host tail makes
#: each run 0.1-1 s), so that the SSB bench phases fit the time limit
RT_REPEATS_DEFAULT = 3
RT_FETCH_ROWS = 50_000              # rows per fetch batch of the consumer
#: the consuming segment's freeze points checked (the frozen prefix
#: doubles from MutableSegmentImpl.FREEZE_MIN_ROWS)
RT_FREEZES = (1 << 20, 1 << 21, 1 << 22)
RT_TAIL_BATCHES = 2                 # fetch batches indexed after a freeze
RT_FAMILIES = ("aggregation", "group_by", "selection", "mv_group_by")


def liveness_lane(n_rows: int, num_docs, seed: int) -> torch.Tensor:
    """A uint8 liveness lane on the card: a third of each segment's rows
    superseded, padding rows 0 (`num_docs`: the live rows of each of the
    n_rows // P segments, or one int)."""
    docs = [num_docs] if isinstance(num_docs, int) else list(num_docs)
    P = n_rows // len(docs)
    rng = np.random.default_rng(seed)
    live = (rng.random(n_rows) >= 1 / 3).astype(np.uint8).reshape(-1, P)
    for i, d in enumerate(docs):
        live[i, d:] = 0
    return torch.from_numpy(live.reshape(-1)).to("cuda")


def vdoc_check(seg, plan, cols, case: str, seed: int):
    """K1 with the vdoc node ANDed into a plan's filter (the planner's
    with_valid_doc_mask) over a liveness lane: bit-equal to the plain
    version in both instantiations; timed beside the same K1 without the
    node, the general instantiation, the plain version and the bound (the
    unmasked K1's bytes and one byte a row more). Returns its entry."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.query.plan import VALID_DOC_COLUMN, \
        with_valid_doc_mask
    P, n = seg.padded_docs, seg.num_docs
    spec = with_valid_doc_mask(plan.filter_spec)
    cols = dict(cols)
    cols[f"{VALID_DOC_COLUMN}.vdoc"] = liveness_lane(P, n, seed)
    keys = K.filter_lane_keys(spec)
    device = cols[keys[0]].device

    def wide():
        return K._launch_filter(spec, cols, plan.params, keys, device, P, P,
                                None, n, None, general=True)

    K.reset_launch_counts()
    got = K.filter_mask(P, spec, cols, plan.params, n)
    torch.cuda.synchronize()
    if K.launch_counts()["filter_mask[vdoc]"] != 1:
        raise AssertionError(f"vdoc {case}: the node was not launched")
    ref = K.filter_mask_plain(P, spec, cols, plan.params, n)
    err = max(int((got.int() - ref.int()).abs().max()),
              int((wide().int() - ref.int()).abs().max()))
    lane_bytes = sum(cols[k].numel() * cols[k].element_size() for k in keys)
    b = bound(lane_bytes + P, P * 2 * len(keys))
    r = {"kernel": "filter_mask[vdoc]", "case": case,
         "matched": int(ref.sum()), "unmasked_matched": int(
             K.filter_mask(P, plan.filter_spec, cols, plan.params,
                           n).sum()),
         "max_abs_err": err,
         "ms": time_ms(lambda: K.filter_mask(P, spec, cols, plan.params, n)),
         "ms_general": time_ms(wide),
         "ms_without_node": time_ms(lambda: K.filter_mask(
             P, plan.filter_spec, cols, plan.params, n)),
         "plain_ms": time_ms(lambda: K.filter_mask_plain(
             P, spec, cols, plan.params, n)),
         "bound_ms": b[0], "bound_by": b[1], "bytes_over_unmasked": P}
    emit({"phase": "kernel_check", **r})
    if err:
        raise AssertionError(f"filter_mask[vdoc] {case} disagrees: {err}")
    return dict(max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
                bound=b, library_ms=None)


def _rt_rows(cols) -> list:
    """A fetch batch's rows as the decoder hands them to the consumer:
    one dict per row."""
    from pinot_tpu_torch.tools import baseball
    vals = {}
    for name, c in cols.items():
        if isinstance(c, baseball.Categorical):
            vals[name] = c.pool[c.codes].tolist()
        elif isinstance(c, baseball.MultiValue):
            vals[name] = c.lists()
        else:
            vals[name] = c.tolist()
    names = list(vals)
    return [dict(zip(names, row)) for row in zip(*vals.values())]


def _rt_key_codes(cols) -> np.ndarray:
    """One int64 code per row for its primary key (RT_PK)."""
    from pinot_tpu_torch.tools import baseball
    year = cols["yearID"].astype(np.int64) - 1990
    return ((cols["playerName"].codes.astype(np.int64) * 30 + year) *
            len(baseball.TEAMS) + cols["teamID"].codes) * 2 + \
        cols["league"].codes


class RtTable:
    """The upsert table's rows in ingestion order, for the oracle: the
    columns in the oracle's form and the key code of every row."""

    def __init__(self):
        self.parts, self.keys = [], []

    def add(self, cols) -> None:
        self.parts.append(cols)
        self.keys.append(_rt_key_codes(cols))

    def live_oracle(self):
        """The numpy oracle of the live rows: the latest row of each key
        among the rows ingested so far."""
        from pinot_tpu_torch.tools import baseball
        keys = np.concatenate(self.keys)
        _, last = np.unique(keys[::-1], return_index=True)
        live = np.sort(len(keys) - 1 - last)
        cols = baseball.concat_columns(self.parts)
        self.parts = [cols]              # concatenated once
        self.keys = [keys]
        out = {}
        for name, c in cols.items():
            if isinstance(c, (baseball.Categorical, baseball.MultiValue)):
                out[name] = type(c)(c.pool, c.codes[live])
            else:
                out[name] = c[live]
        return baseball.Oracle(out), len(keys)


def _rt_draws(oracle):
    from pinot_tpu_torch.tools import baseball
    gens = {"aggregation": baseball.aggregation_draws,
            "group_by": baseball.group_by_draws,
            "selection": baseball.selection_draws,
            "mv_group_by": baseball.mv_group_by_draws}
    return [(f, d) for f in RT_FAMILIES for d in gens[f](oracle)]


def rt_checkpoint(label, engine, mutable, rt, repeats: int, extra=None):
    """One check of the consuming table: launch and path counts from 0,
    the phase-9 families once through QueryEngine over the sealed
    segments and the consuming one, each answer against the live-row
    oracle; every K1 launch carried the vdoc node, the frozen prefix ran
    the kernels and only the tail (every query's, and nothing else but
    the planner's refusals) the host twin. Then the p50 of `repeats`
    timed runs per family. Returns the checkpoint's launch counts."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import baseball
    t0 = time.perf_counter()
    oracle, ingested = rt.live_oracle()
    oracle_s = time.perf_counter() - t0
    draws = _rt_draws(oracle)
    frozen = mutable._frozen
    tail = mutable.num_docs - (frozen.num_docs if frozen is not None else 0)
    segs = [s for s in engine.segments if s is not mutable]
    lanes = [s for s in segs + [frozen] if s is not None]
    vdoc_before = [(s.vdoc_uploads, s.vdoc_upload_bytes) for s in lanes]
    K.reset_launch_counts()
    ex = engine.executor
    ex.reset_path_counts()
    answered, first_query_uploads = [], None
    for family, draw in draws:
        host_before, tail_before = ex.path_counts["host"], ex.tail_docs
        t = time.perf_counter()
        resp = engine.query(draw.pql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if first_query_uploads is None:
            first_query_uploads = [
                (s.vdoc_uploads - u, s.vdoc_upload_bytes - b)
                for s, (u, b) in zip(lanes, vdoc_before)]
        # the tail is the host twin's on every query; a refused plan
        # sends the other segments there too
        on_host = ex.path_counts["host"] - host_before > (1 if tail else 0)
        if on_host != draw.host_answered:
            raise AssertionError(f"{label} {draw.pql}: host twin {on_host}, "
                                 f"expected {draw.host_answered}")
        if ex.tail_docs - tail_before != tail:
            raise AssertionError(f"{label}: the host twin read "
                                 f"{ex.tail_docs - tail_before} tail rows, "
                                 f"the tail has {tail}")
        answered.append((family, draw, resp, ms, on_host))
    launches = K.launch_counts()
    paths = dict(ex.path_counts)
    uploads = [(s.vdoc_uploads - u, s.vdoc_upload_bytes - b)
               for s, (u, b) in zip(lanes, vdoc_before)]
    t = time.perf_counter()
    for _f, draw, resp, _ms, _h in answered:
        baseball.check(resp, oracle, draw)
    check_s = time.perf_counter() - t
    if not launches["filter_mask[vdoc]"] or \
            launches["filter_mask[vdoc]"] != launches["filter_mask"]:
        raise AssertionError(f"{label}: K1 launched {launches['filter_mask']}"
                             f" times, {launches['filter_mask[vdoc]']} with "
                             "the vdoc node")
    if paths["scan"] < len(draws) - sum(h for *_x, h in answered):
        raise AssertionError(f"{label}: paths {paths}")
    families = {}
    t = time.perf_counter()
    for family, draw, _resp, first_ms, on_host in answered:
        if on_host:
            families.setdefault(f"{family}_host", []).append(first_ms)
            continue
        for _ in range(repeats):
            t0 = time.perf_counter()
            engine.query(draw.pql)
            torch.cuda.synchronize()
            families.setdefault(family, []).append(
                (time.perf_counter() - t0) * 1e3)
    timed_s = time.perf_counter() - t
    emit({"phase": "realtime", "check": label, "queries_passed": len(draws),
          "rows_ingested": ingested, "live_rows": oracle.n,
          "consuming_rows": mutable.num_docs,
          "frozen_rows": frozen.num_docs if frozen is not None else 0,
          "tail_rows": tail, "sealed_segments": len(segs),
          "host_answered": sum(h for *_x, h in answered),
          "p50_ms_by_family": {f: float(np.median(ts))
                               for f, ts in families.items()},
          "tail_host_ms_per_query": ex.tail_ms / len(draws),
          "vdoc_uploads_first_query": sum(u for u, _b in
                                          first_query_uploads),
          "vdoc_bytes_first_query": sum(b for _u, b in first_query_uploads),
          "vdoc_uploads_per_query": sum(u for u, _b in uploads) / len(draws),
          "vdoc_bytes_per_query": sum(b for _u, b in uploads) / len(draws),
          "paths": paths, "oracle_seconds": oracle_s,
          "check_seconds": check_s, "timed_seconds": timed_s,
          "launches": {k: v for k, v in launches.items() if v},
          **(extra or {})})
    return launches, answered, oracle


def rt_freeze(mutable, engine, rt) -> dict:
    """Cross a freeze point: the rebuild (MutableSegmentImpl.device_view,
    host) and the upload of the lanes the families' plans read (the
    first query after a freeze pays both), timed apart."""
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands
    from pinot_tpu_torch.query.plan import GroupsLimitExceeded, \
        UnsupportedOnDevice
    freezes = mutable.freezes
    t0 = time.perf_counter()
    frozen, _tail = mutable.device_view()
    rebuild_s = time.perf_counter() - t0
    if mutable.freezes != freezes + 1:
        raise AssertionError("no freeze at the freeze point")
    oracle, _n = rt.live_oracle()
    t0 = time.perf_counter()
    planned = 0
    for _f, draw in _rt_draws(oracle):
        request = engine.optimizer.optimize(compile_pql(draw.pql))
        try:
            plan = engine.executor.plan_maker.make_segment_plan(frozen,
                                                                request)
        except (UnsupportedOnDevice, GroupsLimitExceeded):
            continue             # the host twin answers these
        if plan.fast_path_result is None:
            gather_operands(plan)
            planned += 1
    torch.cuda.synchronize()
    return {"freeze_rows": frozen.num_docs, "rebuild_seconds": rebuild_s,
            "upload_seconds": time.perf_counter() - t0,
            "frozen_device_bytes": frozen.device_bytes(),
            "plans_uploaded": planned}


def rt_freeze_points(rows: int) -> list:
    """The last three freeze points of a consuming segment of `rows` rows
    (1,048,576, 2,097,152 and 4,194,304 at 5,000,000)."""
    from pinot_tpu_torch.realtime.mutable_segment import MutableSegmentImpl
    points, f = [], MutableSegmentImpl.FREEZE_MIN_ROWS
    while f < rows:
        points.append(f)
        f *= 2
    return points[-len(RT_FREEZES):]


def run_realtime(base, args):
    """Phase realtime: the upsert table baseballStats_REALTIME ingested
    the way the LLC consumer does (pinot_tpu/realtime/data_manager.py:
    179-206): per fetch batch index_rows, then apply_batch with (key,
    base + i); at --rt-rows rows convert, seal, load on the card and
    attach_or_fold. --rt-sealed segments seal, then one consuming segment
    is checked at its freeze points (RT_TAIL_BATCHES fetch batches after
    each, so that a tail runs on the host twin) and when it is full; then
    it seals too, and the sealed set runs stacked and in batches. Returns
    (per-segment and stacked launches, batch launches, summary)."""
    from pinot_tpu_torch.common.table_config import TableType, UpsertConfig
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.realtime import converter
    from pinot_tpu_torch.realtime.mutable_segment import MutableSegmentImpl
    from pinot_tpu_torch.realtime.segment_name import LLCSegmentName
    from pinot_tpu_torch.realtime.upsert import TableUpsertMetadataManager
    from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
    from pinot_tpu_torch.tools import baseball
    rows_per_seg = args.rt_rows
    fetch = min(RT_FETCH_ROWS, max(1, rows_per_seg // 20))
    schema = baseball.make_schema()
    cfg = baseball.make_table_config()
    cfg.table_type = TableType.REALTIME
    cfg.upsert_config = UpsertConfig(mode="FULL",
                                     primary_key_columns=list(RT_PK))
    cfg.indexing_config.stream_configs = {
        "realtime.segment.flush.threshold.size": str(rows_per_seg)}
    mgr = TableUpsertMetadataManager(cfg.table_name_with_type,
                                     cfg.upsert_config, schema,
                                     os.path.join(base, "upsert"))
    part = mgr.partition(0)
    rt, sealed, freezes = RtTable(), [], []
    seconds = collections.Counter()
    launches = collections.Counter()
    offset = batches = 0
    for seq in range(args.rt_sealed + 1):
        name = LLCSegmentName("baseballStats", 0, seq).name
        mutable = MutableSegmentImpl(schema, cfg, name)
        mutable.valid_doc_ids = part.register_consuming(seq)
        consuming = seq == args.rt_sealed
        points = rt_freeze_points(rows_per_seg) if consuming else []
        check_at = None
        while mutable.num_docs < rows_per_seg:
            n = min(fetch, rows_per_seg - mutable.num_docs)
            batches += 1
            t0 = time.perf_counter()
            cols = baseball.make_columns(n, seed=args.seed + 7919 * batches)
            rows = _rt_rows(cols)
            t1 = time.perf_counter()
            keys = [mgr.key_of(r) for r in rows]
            mutable.index_rows(rows)
            t2 = time.perf_counter()
            first = mutable.num_docs - len(rows)
            offset += len(rows)
            part.apply_batch(seq, [(k, first + i) for i, k in enumerate(keys)],
                             offset)
            t3 = time.perf_counter()
            seconds["rows"] += t1 - t0
            seconds["index"] += t2 - t1
            seconds["apply"] += t3 - t2
            rt.add(cols)
            del rows, keys
            frozen = mutable._frozen
            if points and mutable.num_docs >= points[0] and (
                    frozen is None or
                    mutable.num_docs >= 2 * frozen.num_docs):
                point = points.pop(0)
                engine = QueryEngine(sealed + [mutable])
                fr = rt_freeze(mutable, engine, rt)
                fr["freeze_point"] = point
                freezes.append(fr)
                emit({"phase": "realtime_freeze", **fr})
                check_at = (f"freeze {point}", fr,
                            mutable.num_docs + RT_TAIL_BATCHES * fetch)
            if check_at and (mutable.num_docs >= check_at[2] or
                             mutable.num_docs >= rows_per_seg):
                engine = QueryEngine(sealed + [mutable])
                got, _a, _o = rt_checkpoint(check_at[0], engine, mutable, rt,
                                            args.rt_repeats)
                launches.update(got)
                check_at = None
        if consuming:
            engine = QueryEngine(sealed + [mutable])
            got, _a, _o = rt_checkpoint(f"full {mutable.num_docs}", engine,
                                        mutable, rt, args.rt_repeats)
            launches.update(got)
        # the commit: convert, seal the key map, load on the card, attach
        seg_dir = os.path.join(base, name)
        t0 = time.perf_counter()
        converter.convert(mutable, seg_dir, name)
        t1 = time.perf_counter()
        part.seal(seq, offset, mutable.num_docs)
        t2 = time.perf_counter()
        seg = ImmutableSegmentLoader.load(seg_dir).to("cuda")
        t3 = time.perf_counter()
        mgr.on_committed_segment(name, seg)
        t4 = time.perf_counter()
        if seg.valid_doc_ids is not mutable.valid_doc_ids:
            raise AssertionError(f"{name}: the sealed segment did not take "
                                 "the consuming segment's bitmap")
        seconds["convert"] += t1 - t0
        seconds["seal"] += t2 - t1
        seconds["load"] += t3 - t2
        seconds["attach"] += t4 - t3
        emit({"phase": "realtime_seal", "segment": name,
              "rows": seg.num_docs,
              "superseded": seg.valid_doc_ids.num_invalid,
              "convert_seconds": t1 - t0, "seal_seconds": t2 - t1,
              "load_seconds": t3 - t2, "attach_seconds": t4 - t3,
              "key_map_size": mgr.key_map_size()})
        mutable.destroy()
        sealed.append(seg)
    rows = offset
    ingest = {"rows": rows, "fetch_rows": fetch,
              "rows_per_s_index": rows / seconds["index"],
              "rows_per_s_index_apply": rows / (seconds["index"] +
                                                seconds["apply"]),
              "row_synthesis_seconds": seconds["rows"],
              "index_seconds": seconds["index"],
              "apply_seconds": seconds["apply"],
              "convert_seconds": seconds["convert"],
              "seal_seconds": seconds["seal"],
              "load_seconds": seconds["load"],
              "attach_seconds": seconds["attach"]}
    emit({"phase": "realtime_ingest", **ingest})

    # the sealed set, stacked: every query on the stacked route with the
    # [S, P] liveness lane, every answer the per-segment one's
    seq_engine = QueryEngine(sealed)
    st_engine = QueryEngine(sealed, mesh=make_mesh())
    oracle, _n = rt.live_oracle()
    stack = st_engine.sharded.stack_for(st_engine.segments)
    judged = 0
    st_launches, routes = collections.Counter(), collections.Counter()
    families = {}
    for family, draw in _rt_draws(oracle):
        K.reset_launch_counts()
        resp = st_engine.query(draw.pql)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        route, reason = st_engine.last_route
        # the planner's refusals go to the host twin, and a filter that
        # folds to nothing has no device work to stack (a fast path);
        # everything else stacks, with the vdoc node in its one K1 a
        # dispatch (a group-by's scouts, phase B and kmax rungs)
        if route == "NotShardable" and reason.startswith("fast-path"):
            route = "fast_path"
        routes[route] += 1
        g = K.group_route_counts
        dispatches = 1 + g["scout"] + g["hist"] + g["escalation"]
        if draw.host_answered != (route == "UnsupportedOnDevice") or \
                route not in ("stacked", "fast_path",
                              "UnsupportedOnDevice") or \
                (route == "stacked" and (
                    counts["filter_mask[vdoc]"] != dispatches or
                    counts["filter_mask"] != dispatches)):
            raise AssertionError(f"{draw.pql}: route {route} ({reason}), "
                                 f"launches {counts}")
        st_launches.update(counts)
        baseball.check(resp, oracle, draw)
        if not same_answer(resp, seq_engine.query(draw.pql),
                           baseball.FLOAT_RTOL):
            judged += 1       # a selection's ties: the oracle judged it
        if route == "stacked":
            ts = []
            for _ in range(args.rt_repeats):
                t0 = time.perf_counter()
                st_engine.query(draw.pql)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            families.setdefault(family, []).extend(ts)
    lane = stack.vdoc_lane()
    if lane.shape != (len(sealed), stack.padded_docs) or \
            int(lane.sum()) != oracle.n:
        raise AssertionError(f"stacked liveness lane {tuple(lane.shape)} "
                             f"holds {int(lane.sum())} live rows, the "
                             f"oracle {oracle.n}")
    emit({"phase": "realtime_stacked", "segments": len(sealed),
          "queries_passed": sum(1 for _ in _rt_draws(oracle)),
          "live_rows": oracle.n, "judged_by_oracle": judged,
          "routes": dict(routes),
          "vdoc_lane_shape": list(lane.shape),
          "vdoc_uploads": stack.vdoc_uploads,
          "vdoc_upload_bytes": stack.vdoc_upload_bytes,
          "p50_ms_by_family": {f: float(np.median(ts))
                               for f, ts in families.items()},
          "launches": {k: v for k, v in st_launches.items() if v}})
    launches.update(st_launches)
    # cross-query batches over the sealed set: the shared liveness lane
    draws = baseball.batch_draws(oracle)
    batch = run_batch(
        "realtime", seq_engine, {f: [d.pql for d in ds]
                                 for f, ds in draws.items()},
        lambda f, i, resp: baseball.check(resp, oracle, draws[f][i]),
        args.batch_repeats)
    if not batch["filter_mask_batched[vdoc]"]:
        raise AssertionError("no batched K1 launch carried the vdoc node")
    summary = {"ingest": ingest, "freezes": freezes,
               "segments": len(sealed), "rows_per_segment": rows_per_seg,
               "live_rows": oracle.n, "key_map_size": mgr.key_map_size()}
    mgr.close()
    return dict(launches), batch, summary


# ---------------------------------------------------------------------------
# Multi-stage joins and windows: lineorderj x part (SSB SF10, normalised)
# ---------------------------------------------------------------------------

#: SSB SF10 (O'Neil et al., Star Schema Benchmark rev. 3, 2.2): LINEORDER
#: 6,000,000 x SF rows, PART 200,000 x floor(1 + log2 SF)
JOIN_FACT_ROWS = 60_000_000
JOIN_DIM_ROWS = 800_000
JOIN_SEGMENTS = 8
_JOIN_FROM = ("FROM lineorderj JOIN part ON lineorderj.lo_partkey = "
              "part.p_partkey")
_JOIN_SELECT = "SELECT SUM(lineorderj.lo_revenue), COUNT(*) " + _JOIN_FROM
#: the single-join forms of SSB flight 2 (the supplier join dropped: the
#: engine takes one join) and a no-GROUP-BY query (the K2 path):
#: {name: (pql, dim filter, fact filter, oracle group columns)}
JOIN_QUERIES = {
    "J0": (_JOIN_SELECT + " WHERE part.p_category = 'MFGR#12' AND "
           "lineorderj.lo_quantity < 25",
           lambda d: d["p_category"] == "MFGR#12",
           lambda f: f["lo_quantity"] < 25, []),
    "J2.1": (_JOIN_SELECT + " WHERE part.p_category = 'MFGR#12' GROUP BY "
             "part.p_brand1, lineorderj.d_year TOP 5000",
             lambda d: d["p_category"] == "MFGR#12", None,
             ["part.p_brand1", "lineorderj.d_year"]),
    "J2.2": (_JOIN_SELECT + " WHERE part.p_brand1 BETWEEN 'MFGR#2221' AND "
             "'MFGR#2228' GROUP BY part.p_brand1, lineorderj.d_year TOP "
             "5000",
             lambda d: (d["p_brand1"] >= "MFGR#2221") &
             (d["p_brand1"] <= "MFGR#2228"), None,
             ["part.p_brand1", "lineorderj.d_year"]),
    "J2.3": (_JOIN_SELECT + " WHERE part.p_brand1 = 'MFGR#2239' GROUP BY "
             "lineorderj.d_year TOP 5000",
             lambda d: d["p_brand1"] == "MFGR#2239", None,
             ["lineorderj.d_year"]),
}
#: the queries of the raw-key segments (join_raw / jraw)
RAW_KEY_JOIN_QUERIES = ("J0", "J2.1", "J2.3")
#: the raw-key table: the first segments' rows again, lo_partkey raw (a
#: depth cut of the 8; two, so the stacked path runs it)
RAW_KEY_JOIN_SEGMENTS = 2
#: the window scan selects between these many rows (n_pad = 65,536)
WINDOW_ROWS = (32_769, 65_536)
_WINDOW_COLS = "SELECT d_year, lo_quantity, "
WINDOW_QUERIES = {
    # scripts/join_smoke.py:161-165, at the cap
    "W1": _WINDOW_COLS + "ROW_NUMBER() OVER (PARTITION BY d_year ORDER BY "
          "lo_revenue DESC), SUM(lo_quantity) OVER (PARTITION BY d_year "
          "ORDER BY lo_revenue DESC) FROM lineorderj WHERE {where} LIMIT "
          "65536",
    # two order keys, no PARTITION BY
    "W2": _WINDOW_COLS + "ROW_NUMBER() OVER (ORDER BY d_year, lo_revenue), "
          "SUM(lo_quantity) OVER (ORDER BY d_year, lo_revenue) FROM "
          "lineorderj WHERE {where} LIMIT 65536",
}
#: the kernels of the join and window paths (K12, K13) and the K1 / K3
#: nodes they add
STAGE_KERNELS = ("radix_sort", "radix_sort_join", "window_scan")


def join_data(base, args):
    """The join tables from --seed, built by the port's SegmentCreator into
    `base` and loaded on the card: lineorderj in --join-segments segments,
    the rows of its first RAW_KEY_JOIN_SEGMENTS segments again with
    lo_partkey raw (the JAX config of tests/test_stages.py:255-283, a depth
    cut), and part in one segment. Returns (fact segments, raw-key
    segments, dim segment, dim columns, fact columns, raw-key fact
    columns, report)."""
    from pinot_tpu_torch.segment.creator import SegmentCreator
    from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
    from pinot_tpu_torch.tools import datagen
    from pinot_tpu_torch.common.table_config import IndexingConfig, \
        TableConfig
    t0 = time.perf_counter()
    dim, fact = datagen.make_join_rows(args.join_rows,
                                       dim_rows=args.join_dim_rows,
                                       seed=args.seed)
    rows_s = time.perf_counter() - t0
    fact_cfg, dim_cfg = datagen.join_table_configs()
    per = -(-args.join_rows // args.join_segments)

    def build(schema, cfg, cols, name):
        d = os.path.join(base, name)
        SegmentCreator(schema, cfg, segment_name=name).build(cols, d)
        return d

    t0 = time.perf_counter()
    fact_dirs = [build(datagen.fact_join_schema(), fact_cfg,
                       {k: v[i * per:(i + 1) * per] for k, v in fact.items()},
                       f"factj_{i}") for i in range(args.join_segments)]
    n_raw = min(RAW_KEY_JOIN_SEGMENTS, args.join_segments)
    raw_fact = {k: v[:n_raw * per] for k, v in fact.items()}
    raw_cfg = TableConfig("lineorderj", indexing_config=IndexingConfig(
        no_dictionary_columns=["lo_partkey"]))
    raw_dirs = [build(datagen.fact_join_schema(), raw_cfg,
                      {k: v[i * per:(i + 1) * per]
                       for k, v in raw_fact.items()}, f"factj_raw_{i}")
                for i in range(n_raw)]
    dim_dir = build(datagen.part_dim_schema(), dim_cfg, dim, "partd_0")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    segs = [ImmutableSegmentLoader.load(d) for d in fact_dirs]   # the card
    raw_segs = [ImmutableSegmentLoader.load(d) for d in raw_dirs]
    dim_seg = ImmutableSegmentLoader.load(dim_dir)
    load_s = time.perf_counter() - t0
    report = {"phase": "join_data", "fact_rows": args.join_rows,
              "fact_segments": len(segs), "dim_rows": args.join_dim_rows,
              "raw_key_segments": len(raw_segs),
              "raw_key_rows": sum(s.num_docs for s in raw_segs),
              "padded_rows_per_segment": segs[0].padded_docs,
              "lo_partkey_cardinality": [
                  s.data_source("lo_partkey").metadata.cardinality
                  for s in segs],
              "rows_seconds": rows_s, "build_seconds": build_s,
              "load_seconds": load_s,
              "disk_bytes": sum(os.path.getsize(os.path.join(d, f))
                                for d in fact_dirs + raw_dirs + [dim_dir]
                                for f in os.listdir(d))}
    emit(report)
    return segs, raw_segs, dim_seg, dim, fact, raw_fact, report


def _sub(cols, mask):
    return {k: v[mask] for k, v in cols.items()}


def join_oracle_dict(dim, fact, dim_filter, fact_filter, group_cols,
                     probe):
    """join_oracle's answer as {group tuple of strings: value} for the
    SUM and for the COUNT; `probe`: the table's join_probe, computed once
    for every query."""
    from pinot_tpu_torch.tools import datagen
    if fact_filter is not None:
        keep = fact_filter(fact)
        fact, probe = _sub(fact, keep), (probe[0][keep], probe[1][keep])
    o = datagen.join_oracle(dim, fact, dim_filter=dim_filter,
                            group_cols=group_cols, probe=probe)
    if not group_cols:
        return [{(): float(o["sum_revenue"])}, {(): float(o["count"])}]
    return [{tuple(str(x) for x in k): float(v[i])
             for k, v in o["groups"].items()} for i in range(2)]


def response_dict(resp, fi: int) -> dict:
    """{group tuple: float value} of a response's aggregation fi."""
    agg = resp.to_json()["aggregationResults"][fi]
    if agg.get("groupByResult") is None:
        return {(): float(agg["value"])}
    return {tuple(str(x) for x in g["group"]): float(g["value"])
            for g in agg["groupByResult"]}


_REQUEST_IDS = itertools.count(1)


def stage1_publish(server, scan, xid: str, segments=None) -> dict:
    """A stage-1 scan as the broker dispatches it: an InstanceRequest
    carrying publish_exchange (and `segments`, its search segments, where
    given) to the ServerInstance that holds the table, whose epilogue (server/instance.py:_maybe_publish) publishes
    the DataTable in its exchange and answers with an ack, or with the
    typed exchangeCapacity error when the scan matched more rows than the
    block holds. Returns the source descriptor: the in-process registry
    key and the instance's TCP address."""
    from pinot_tpu_torch.common.datatable import DataTable
    from pinot_tpu_torch.common.request import InstanceRequest
    from pinot_tpu_torch.common.serde import instance_request_to_bytes
    ack = DataTable.from_bytes(server.handle_request_bytes(
        instance_request_to_bytes(InstanceRequest(
            request_id=next(_REQUEST_IDS), query=scan,
            search_segments=segments, publish_exchange={"id": xid}))))
    if ack.exceptions:
        raise AssertionError(f"stage-1 scan {xid}: {ack.exceptions}")
    return {"server": server.instance_id,
            "xkey": ack.metadata["exchangeKey"], "id": xid,
            "rows": int(ack.metadata["exchangeRows"]),
            "host": "127.0.0.1", "port": server.port}


def join_stage2(req, sources, segments, executor):
    """Stage 2 on a fact server: the JoinContext from the exchanged
    blocks, attached, the executor's block reduced."""
    from pinot_tpu_torch.query.reduce import BrokerReduceService
    from pinot_tpu_torch.query.stages import join as jmod
    ctx = jmod.build_context(req.join, sources, jmod.fact_partition_info(
        segments, req.join.fact_key))
    r = jmod.attach(req, ctx, segments)
    resp = BrokerReduceService().reduce(req, [executor.execute(r,
                                                               segments)])
    return resp, ctx, r


def _join_k1_check(name, P, n, spec, cols, params, library):
    """K1 over one join program (member or join_raw leaf) against its
    plain version, timed beside the bound (the key lane read once, the
    mask written once, the member bits or sorted keys read once) and the
    nearest PyTorch call."""
    from pinot_tpu_torch.ops import kernels as K
    got = K.filter_mask(P, spec, cols, params, n)
    ref = K.filter_mask_plain(P, spec, cols, params, n)
    err = int((got.int() - ref.int()).abs().max())
    keys = K.filter_lane_keys(spec)
    probes = []
    K.compile_filter(spec, params, cols, probes)
    nbytes = sum(cols[k].numel() * cols[k].element_size() for k in keys) + \
        P + sum(t.numel() * t.element_size() for t in probes) + \
        sum(np.asarray(p).size // 8 for p in params
            if isinstance(p, np.ndarray) and p.dtype == bool)
    b = bound(nbytes, P * 18 * len(keys))
    # a 2^21-entry member table takes the host milliseconds to pack into
    # the program: a longer spin keeps that host work out of the events
    r = {"kernel": "filter_mask", "case": name, "matched": int(ref.sum()),
         "max_abs_err": err,
         "ms": time_ms(lambda: K.filter_mask(P, spec, cols, params, n),
                       spins=20),
         "plain_ms": time_ms(lambda: K.filter_mask_plain(P, spec, cols,
                                                         params, n)),
         "library_ms": time_ms(library), "bound_ms": b[0], "bound_by": b[1]}
    emit({"phase": "join_kernel_check", **r})
    if err:
        raise AssertionError(f"filter_mask {name} disagrees: {err}")
    return dict(max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
                bound=b, library_ms=r["library_ms"])


def _join_plan(seg, req, ctx):
    from pinot_tpu_torch.query.execution import gather_operands
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    from pinot_tpu_torch.query.stages import join as jmod
    plan = InstancePlanMaker().make_segment_plan(seg, jmod.attach(req, ctx,
                                                                  [seg]))
    return plan, gather_operands(plan)


def join_kernel_check(seg, raw_seg, j21, window_case):
    """K1 (member and join_raw leaves), K3 (jcode, jraw), K12 (the join's
    dim side and the window's lanes) and K13 against their plain versions
    on the card, on segment 0's lanes and the raw-key segment's with
    J2.1's real dim side, and on W1's real window lanes (K13 also on 2^24
    rows, one partition and singletons); timed with the L2 flushed,
    beside their bounds and the nearest PyTorch call. Returns {entry
    name: entry}."""
    from pinot_tpu_torch.ops import kernels as K
    req, ctx = j21
    entries = {}
    # K1: the member leaf (dictionary key) and the join_raw leaf (raw key)
    plan, cols = _join_plan(seg, req, ctx)
    ids = cols["lo_partkey.ids"]
    device = ids.device
    member = torch.from_numpy(np.asarray(plan.params[0])).to(device)
    entries["filter_mask[member]"] = _join_k1_check(
        "j2.1 member (dictionary key)", seg.padded_docs, seg.num_docs,
        plan.filter_spec, cols, plan.params,
        lambda: member[ids.long()])
    raw_plan, raw_cols = _join_plan(raw_seg, req, ctx)
    lane = raw_cols["lo_partkey.raw"]
    sk = raw_plan.params[0].on(lane.device)[0]
    entries["filter_mask[join_raw]"] = _join_k1_check(
        "j2.1 join_raw (raw key)", raw_seg.padded_docs, raw_seg.num_docs,
        raw_plan.filter_spec, raw_cols, raw_plan.params,
        lambda: torch.searchsorted(sk, lane))
    # K3: jcode on segment 0, jraw on the raw-key segment, J2.1's keys
    for name, (p, c, sg) in {"jcode": (plan, cols, seg),
                             "jraw": (raw_plan, raw_cols, raw_seg)}.items():
        mask = K.filter_mask(sg.padded_docs, p.filter_spec, c, p.params,
                             sg.num_docs)
        keys = group_operands(p, c)[0]
        jkey = keys[0]
        if name == "jcode":
            # a gather reads only the code entries of the matched rows'
            # dictIds, 4 B each
            touched = int(torch.unique(jkey.lane[mask.bool()]).numel())
            tbytes = 4 * touched
        else:
            # the search reads the sorted dim keys and their codes
            touched = jkey.table.numel()
            tbytes = touched * (jkey.table.element_size() + 4)
        r, err, ms, plain, b = k3_check(sg.padded_docs, p, c, mask,
                                        extra_bytes=tbytes)
        r["table_entries_read"] = touched
        if name == "jcode":
            lib = lambda: jkey.table[jkey.lane.long()]    # noqa: E731
        else:
            lib = lambda: torch.searchsorted(jkey.table, jkey.lane)  # noqa
        r["library_ms"] = time_ms(lib)
        emit({"phase": "join_kernel_check", "kernel": "dense_group_aggregate",
              "case": f"j2.1 {name}", **r})
        entries[f"dense_group_aggregate[{name}]"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound=b,
            library_ms=r["library_ms"])
    # K12 as the join build: J2.1's dim keys (int32) with their codes
    keys_p, codes_p = ctx.padded_key_codes("p_brand1", np.int32)
    kt = torch.from_numpy(keys_p).to(device)
    ct = torch.from_numpy(codes_p).to(device)
    got = K.radix_sort([kt], [ct], counter="radix_sort_join")
    ref = K.radix_sort_plain([kt], [ct])
    err = int(not (torch.equal(got[1][0], ref[1][0]) and
                   torch.equal(got[2][0], ref[2][0])))
    dp = kt.numel()
    b = bound(dp * 8 + dp * 12, dp * 8 * 3)
    r = {"kernel": "radix_sort_join", "case": "j2.1 dim side",
         "rows": dp, "dim_rows": len(ctx.keys), "max_abs_err": err,
         "ms": time_ms(lambda: K.radix_sort([kt], [ct],
                                            counter="radix_sort_join")),
         "plain_ms": time_ms(lambda: K.radix_sort_plain([kt], [ct])),
         "library_ms": time_ms(lambda: torch.sort(kt, stable=True)),
         "bound_ms": b[0], "bound_by": b[1]}
    emit({"phase": "join_kernel_check", **r})
    entries["radix_sort_join"] = dict(max_abs_err=err, ms=r["ms"],
                                      plain_ms=r["plain_ms"], bound=b,
                                      library_ms=r["library_ms"])
    # K12 and K13 on W1's lanes (65,536 padded rows)
    wreq, columns, n = window_case
    from pinot_tpu_torch.query.stages import window as wmod
    part, orders, sums = wmod.padded_lanes(
        *wmod.window_lanes(wreq, columns, n), device)
    n_pad = part.numel()
    keys = [part] + orders
    got = K.radix_sort(keys, sums, n)
    ref = K.radix_sort_plain(keys, sums, n)
    err = int(not all(torch.equal(a, b_) for a, b_ in
                      zip([got[0]] + got[1] + got[2],
                          [ref[0]] + ref[1] + ref[2])))
    # one stable torch.sort of the (partition, order key) pair as int64
    composite = (part.long() << 32) | (orders[0].long() & 0xFFFFFFFF)
    # the key and value lanes read once, the permutation, sorted keys and
    # values written once; a few operations a row and pass
    b = bound(n_pad * 4 * (len(keys) + len(sums)) +
              n_pad * 4 * (1 + len(keys) + len(sums)),
              n_pad * 3 * 4 * len(keys))
    r = {"kernel": "radix_sort", "case": "w1 lanes", "rows": n,
         "n_pad": n_pad, "order_keys": len(orders), "sum_lanes": len(sums),
         "max_abs_err": err,
         "ms": time_ms(lambda: K.radix_sort(keys, sums, n)),
         "plain_ms": time_ms(lambda: K.radix_sort_plain(keys, sums, n)),
         "library_ms": time_ms(lambda: torch.sort(composite, stable=True)),
         "bound_ms": b[0], "bound_by": b[1]}
    emit({"phase": "join_kernel_check", **r})
    entries["radix_sort"] = dict(max_abs_err=err, ms=r["ms"],
                                 plain_ms=r["plain_ms"], bound=b,
                                 library_ms=r["library_ms"])
    # K13 on W1's sorted lanes, then on 2^24 rows as one partition over
    # every tile (the longest look-back chains) and as singletons; each
    # case WINDOW_SCAN_REPEATS times, bit-equal to the plain version every
    # time (a race in the look-back shows only as a wrong bit)
    rng = np.random.default_rng(13)
    big = 1 << 24
    big_v = [torch.from_numpy(rng.integers(-2 ** 30, 2 ** 30, big)
                              .astype(np.int32)).to(device)]
    cases = [("w1 sorted lanes", got[1][0], got[2]),
             ("2^24 rows, one partition",
              torch.zeros(big, dtype=torch.int32, device=device), big_v),
             ("2^24 rows, every row its own partition",
              torch.arange(big, dtype=torch.int32, device=device), big_v)]
    for case, sp, svals in cases:
        rows = sp.numel()
        rn_p, run_p = K.window_scan_plain(sp, svals)
        err = 0
        for _ in range(WINDOW_SCAN_REPEATS):
            rn, run = K.window_scan(sp, svals)
            err += int(not (torch.equal(rn, rn_p) and all(
                torch.equal(a, b_) for a, b_ in zip(run, run_p))))
        b = bound(rows * 8 * (1 + len(svals)), rows * 4 * (1 + len(svals)))
        r = {"kernel": "window_scan", "case": case, "rows": rows,
             "sum_lanes": len(svals), "repeats": WINDOW_SCAN_REPEATS,
             "max_abs_err": err,
             "ms": time_ms(lambda: K.window_scan(sp, svals)),
             "plain_ms": time_ms(lambda: K.window_scan_plain(sp, svals)),
             "library_ms": time_ms(lambda: torch.cumsum(svals[0], 0)),
             # a copy of the same lanes moves the kernel's bytes: what
             # the memory gives under time_ms's flush
             "copy_ms": time_ms(lambda: [t.clone() for t in [sp] + svals]),
             "launch_us": launch_breakdown(lambda: K.window_scan(sp, svals)),
             "bound_ms": b[0], "bound_by": b[1]}
        emit({"phase": "join_kernel_check", **r})
        if err:
            raise AssertionError(f"window_scan disagrees on {case} in {err} "
                                 f"of {WINDOW_SCAN_REPEATS} runs")
        entries.setdefault("window_scan", dict(
            max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"], bound=b,
            library_ms=r["library_ms"]))
    bad = {k: e["max_abs_err"] for k, e in entries.items()
           if e["max_abs_err"]}
    if bad:
        raise AssertionError(f"join kernels disagree: {bad}")
    return entries


def run_join(segs, raw_segs, dim_server, dim, fact, raw_fact, repeats: int):
    """Stage 1 (through `dim_server`, the ServerInstance holding the part
    table) -> exchange -> stage 2 for J0 and J2.1-J2.3: launch counts
    from 0, each query once per segment (8 segments), stacked and on the
    raw-key segment, each answer equal to join_oracle and to the host
    twin; then the timed repeats. Returns (launches, {query: (request,
    context)}, timing report)."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.parallel.sharded import ShardedQueryExecutor
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query import host_exec
    from pinot_tpu_torch.query.combine import combine_blocks
    from pinot_tpu_torch.query.executor import ServerQueryExecutor
    from pinot_tpu_torch.query.reduce import BrokerReduceService
    from pinot_tpu_torch.query.stages import broker as stages_broker
    sharded = ShardedQueryExecutor(mesh=make_mesh())
    paths = {"per_segment": (segs, ServerQueryExecutor()),
             "stacked": (segs, sharded),
             "raw_key": (raw_segs, ServerQueryExecutor()),
             "raw_key_stacked": (raw_segs, sharded)}
    contexts, checked, seconds = {}, {}, collections.Counter()
    path_launches = {}
    K.reset_launch_counts()
    for q, (pql, dim_filter, fact_filter, gcols) in JOIN_QUERIES.items():
        req = compile_pql(pql)
        t = time.perf_counter()
        src = stage1_publish(dim_server,
                             stages_broker.dim_scan_request(req),
                             f"{q}.0")
        seconds["stage1"] += time.perf_counter() - t
        for path, (ss, ex) in paths.items():
            if path.startswith("raw_key") and \
                    q not in RAW_KEY_JOIN_QUERIES:
                continue
            before = K.launch_counts()
            t = time.perf_counter()
            resp, ctx, r = join_stage2(req, [src], ss, ex)
            torch.cuda.synchronize()
            seconds["stage2"] += time.perf_counter() - t
            path_launches[(q, path)] = {
                k: v - before.get(k, 0)
                for k, v in K.launch_counts().items()
                if v - before.get(k, 0)}
            checked[(q, path)] = (resp, r, ss)
            if path == "per_segment":
                contexts[q] = (req, ctx, src)
    launches = K.launch_counts()
    t = time.perf_counter()
    from pinot_tpu_torch.tools import datagen
    probes = {"fact": datagen.join_probe(dim, fact),
              "raw_key": datagen.join_probe(dim, raw_fact)}
    wants, hosts = {}, {}        # per (query, table): one each
    for (q, path), (resp, r, ss) in checked.items():
        pql, dim_filter, fact_filter, gcols = JOIN_QUERIES[q]
        if resp.exceptions:
            raise AssertionError(f"{q} {path}: {resp.exceptions}")
        table = "raw_key" if path.startswith("raw_key") else "fact"
        if (q, table) not in wants:
            wants[(q, table)] = join_oracle_dict(
                dim, raw_fact if table == "raw_key" else fact,
                dim_filter, fact_filter, gcols, probes[table])
            hosts[(q, table)] = BrokerReduceService().reduce(
                r, [combine_blocks(r, [host_exec.execute_host(s, r)
                                       for s in ss])])
        want, host = wants[(q, table)], hosts[(q, table)]
        for fi in range(2):
            got = response_dict(resp, fi)
            if got != want[fi] or response_dict(host, fi) != want[fi]:
                raise AssertionError(
                    f"{q} {path}: aggregation {fi} differs from "
                    f"join_oracle ({len(got)} / {len(want[fi])} groups)")
        emit({"phase": "join", "query": q, "path": path,
              "check": "pass", "groups": len(response_dict(resp, 0)),
              "joined_rows": int(sum(response_dict(resp, 1).values())),
              "dim_rows": len(contexts[q][1].keys),
              "launches": path_launches[(q, path)]})
    seconds["oracle_and_host_checks"] += time.perf_counter() - t
    needed = ("filter_mask", "filter_mask[join_raw]", "[jcode]",
              "[jraw]", "radix_sort_join", "masked_part_sums")

    def launched(counts, k):
        # a join's group key is evaluated by K14 (the compacted route)
        # or by K3 (the sorted rung, compaction off)
        if k.startswith("["):
            return counts.get(f"block_compact{k}", 0) + \
                counts.get(f"dense_group_aggregate{k}", 0)
        return counts.get(k, 0)

    missing = [k for k in needed if not launched(launches, k)]
    # the stacked raw-key path: join_raw over the stack's raw lane,
    # and the jraw key where a dim column groups (J2.1)
    missing += [f"{q} raw_key_stacked {k}" for q, k in (
        ("J0", "filter_mask[join_raw]"),
        ("J2.1", "filter_mask[join_raw]"),
        ("J2.1", "[jraw]"))
        if not launched(path_launches[(q, "raw_key_stacked")], k)]
    if missing:
        raise AssertionError(f"join kernels never launched: {missing} "
                             f"({launches})")
    # the timed repeats: stage 1 and stage 2 apart, per query and path
    p50 = {}
    for q, (req, _ctx, _src) in contexts.items():
        t1 = []
        for i in range(repeats):
            t = time.perf_counter()
            src = stage1_publish(dim_server,
                                 stages_broker.dim_scan_request(req),
                                 f"{q}.r{i}")
            t1.append((time.perf_counter() - t) * 1e3)
        p50[(q, "stage1")] = float(np.median(t1))
        for path, (ss, ex) in paths.items():
            if path.startswith("raw_key") and \
                    q not in RAW_KEY_JOIN_QUERIES:
                continue
            t2 = []
            for _ in range(repeats):
                t = time.perf_counter()
                join_stage2(req, [src], ss, ex)
                torch.cuda.synchronize()
                t2.append((time.perf_counter() - t) * 1e3)
            p50[(q, path)] = float(np.median(t2))
            emit({"phase": "join", "query": q, "path": path,
                  "stage1_p50_ms": p50[(q, "stage1")],
                  "stage2_p50_ms": p50[(q, path)], "samples_ms": t2})
    stack = sharded.stack_for(segs)
    report = {"phase": "join_summary", "queries_passed": len(checked),
              "segment_device_bytes": sum(s.device_bytes() for s in segs),
              "raw_key_device_bytes": sum(s.device_bytes()
                                          for s in raw_segs),
              "dim_device_bytes": sum(
                  sdm.segment.device_bytes() for sdm in
                  dim_server.data_manager.table("part")._segments
                  .values()),
              "stack_device_bytes": stack.device_bytes(),
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "seconds": dict(seconds), "launches": {
                  k: v for k, v in launches.items() if v}}
    emit(report)
    return launches, {q: (req, ctx) for q, (req, ctx, _s) in
                      contexts.items()}, report


def window_where(fact) -> tuple:
    """A WHERE over lo_partkey that selects between WINDOW_ROWS rows of
    the fact table (the window kernel's full width, n_pad 65,536): the
    keys from the smallest present one up to the one where the count
    first reaches the middle of that range. Returns (where, rows)."""
    keys = fact["lo_partkey"]
    counts = np.bincount(keys[keys >= 0])
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, sum(WINDOW_ROWS) // 2))
    a = int(np.nonzero(counts)[0][0])
    rows = int(cum[b])
    if not WINDOW_ROWS[0] <= rows <= WINDOW_ROWS[1]:
        raise AssertionError(f"window WHERE selects {rows} rows")
    return f"lo_partkey BETWEEN {a} AND {b}", rows


def _window_invariants(blk, scanned: int, partitioned: bool) -> None:
    """scripts/join_smoke.py:178-193: in output order, each partition's
    row numbers count 1, 2, ... and its running sum telescopes by the
    row's quantity (one partition over every row without PARTITION BY);
    every scanned row comes back once."""
    names = blk.selection_columns
    cols = dict(zip(names, blk.selection_cols))
    year, qty = np.asarray(cols["d_year"]), np.asarray(cols["lo_quantity"])
    rn, run = np.asarray(cols[names[2]]), np.asarray(cols[names[3]])
    seen = {}
    for i in range(len(year)):
        key = int(year[i]) if partitioned else 0
        prev = seen.get(key)
        ok = (rn[i] == 1 and run[i] == qty[i]) if prev is None else \
            (rn[i] == prev[0] + 1 and run[i] == prev[1] + qty[i])
        if not ok:
            raise AssertionError(f"window invariants violated at row {i}")
        seen[key] = (int(rn[i]), int(run[i]))
    if sum(s[0] for s in seen.values()) != scanned or len(year) != scanned:
        raise AssertionError(f"window returned {len(year)} rows of "
                             f"{scanned} scanned")


def run_window(fact_server, segs, where: str, rows: int, repeats: int):
    """W1 and W2: stage 1 (each fact segment's scan published by
    `fact_server`, the ServerInstance holding them, as one InstanceRequest
    a segment) -> exchange -> execute_window_stage on the card, launch
    counts from 0; bit-equal to the numpy twin over the same blocks, with the
    rank / telescoping invariants; then the timed repeats. Returns
    (launches, W1's (request, columns, rows) for the kernel check)."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.stages import broker as stages_broker
    from pinot_tpu_torch.query.stages import exchange as xmod
    from pinot_tpu_torch.query.stages import join as jmod
    from pinot_tpu_torch.query.stages import window as wmod

    def stage1(req, tag):
        scan = stages_broker.window_scan_request(req, req)
        return [stage1_publish(fact_server, scan, f"{tag}.{i}",
                               [s.segment_name])
                for i, s in enumerate(segs)]

    results = {}
    K.reset_launch_counts()
    for w, pql in WINDOW_QUERIES.items():
        req = compile_pql(pql.format(where=where))
        sources = stage1(req, w)
        blk = wmod.execute_window_stage(req, sources)
        results[w] = (req, sources, blk)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for name in ("radix_sort", "window_scan"):
        if not launches[name]:
            raise AssertionError(f"{name} never launched on the window "
                                 f"path: {launches}")
    case = None
    for w, (req, sources, blk) in results.items():
        host = wmod.execute_window_stage(req, sources, use_device=False)
        for a, b in zip(blk.selection_cols, host.selection_cols):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"{w}: the card's window differs "
                                     "from the numpy twin")
        if blk.selection_columns != host.selection_columns:
            raise AssertionError(f"{w}: columns differ")
        _window_invariants(blk, rows, bool(req.windows[0].partition_by))
        if w == "W1":
            cols = {}
            for dt in xmod.fetch_blocks(sorted(
                    sources, key=lambda s: (s["server"], s["id"])), None):
                for c, v in jmod.columns_of(dt).items():
                    cols.setdefault(c, []).append(np.asarray(v))
            case = (req, {c: np.concatenate(v) for c, v in cols.items()},
                    rows)
    p50 = {}
    for w, (req, _sources, _blk) in results.items():
        t1, t2 = [], []
        for i in range(repeats):
            t = time.perf_counter()
            sources = stage1(req, f"{w}.r{i}")
            t1.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            wmod.execute_window_stage(req, sources)
            torch.cuda.synchronize()
            t2.append((time.perf_counter() - t) * 1e3)
        p50[w] = (float(np.median(t1)), float(np.median(t2)))
        emit({"phase": "window", "query": w, "check": "pass",
              "where": where, "rows": rows, "stage1_p50_ms": p50[w][0],
              "stage2_p50_ms": p50[w][1], "stage1_samples_ms": t1,
              "stage2_samples_ms": t2})
    return launches, case


# ---------------------------------------------------------------------------
# The JAX bench's SSB path: stage 1 from disk with star-tree cubes, stage 2
# synthesized on the card by K17
# ---------------------------------------------------------------------------

#: bench.py's seed of both stages (pinot_tpu's build_ssb_segment_dirs and
#: make_ssb_device_stack calls, :938, :1049)
BENCH_SEED = 3
#: bench.py's stage-2 table: 100M rows (big_rows)
SYNTH_ROWS = 100_000_000
#: H100 SXM integer instruction rate: each of the 132 SMs issues at most
#: four warp instructions a clock (128 lanes) at the 1,980 MHz boost
#: clock, and the compiler spreads integer adds over the INT32 and the FMA
#: pipes (IADD3 / IMAD), so 128 lanes is the ceiling: the lanes of the
#: guide's 67 TFLOP/s float32 rate, which counts an FMA as two
INT32_OPS_PER_S = 128 * 132 * 1.98e9
#: K17's integer operations a threefry2x32 evaluation: 2 key adds, 20
#: rounds of add, rotate and xor, 5 injections of two adds, the final xor
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2 + 1
#: ... a row: 17 evaluations, 8 randint reductions (three %, a multiply
#: and an add), the float (shift, or, subtract, multiply) and the derived
#: lanes (five divisions and gathers, d_year's division)
SYNTH_OPS_PER_ROW = 17 * THREEFRY_OPS + 8 * 5 + 4 + 6
#: rows at the head of every synthesized segment K17 is checked on, beside
#: one whole segment with its padding
SYNTH_CHECK_HEAD = 65_536


def run_ssb_store(base, args):
    """Stage 1 of the JAX bench (bench.py:932-997) on the card: the SSB
    table at --store-sf (bench.py's seed 3) built by the port's
    SegmentCreator into --segments directories with the nine star-tree
    cubes, loaded, and the 13 queries per segment and stacked, checked
    against the numpy oracle with their cube path counts (launch and path
    counts from 0); the Q1 families as execute_batch batches, each member
    against the oracle; then p50s of --repeats. Returns the phase's launch
    counts."""
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
    from pinot_tpu_torch.tools.datagen import build_ssb_segment_dirs, \
        ssb_pools
    from pinot_tpu_torch.tools.ssb import (Q1_TEMPLATES, SSB_PQLS,
                                           canon_response, check,
                                           make_cpu_queries, q1_batches,
                                           q1_revenue)
    rows = args.store_sf * ROWS_PER_SF
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dirs, ids, cost = build_ssb_segment_dirs(base, rows, args.segments,
                                             seed=BENCH_SEED, star_tree=True)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = QueryEngine([ImmutableSegmentLoader.load(d) for d in dirs])
    load_s = time.perf_counter() - t0
    st_engine = QueryEngine(engine.segments, mesh=make_mesh())
    pools = ssb_pools(BENCH_SEED)
    oracle = make_cpu_queries(pools, ids, cost)

    K.reset_launch_counts()
    answered = {}
    for q, pql in SSB_PQLS.items():
        row = {}
        for label, eng in (("per_segment", engine), ("stacked", st_engine)):
            before = dict(eng.executor.path_counts)
            t = time.perf_counter()
            resp = eng.query(pql)
            torch.cuda.synchronize()
            row[f"{label}_first_ms"] = (time.perf_counter() - t) * 1e3
            if resp.exceptions:
                raise AssertionError(f"{q} ({label}): {resp.exceptions}")
            check(q, canon_response(q, resp), oracle[q]())
            row[f"{label}_paths"] = {
                k: v - before.get(k, 0)
                for k, v in eng.executor.path_counts.items()
                if v != before.get(k, 0)}
        row["stacked_route"] = st_engine.last_route[0]
        answered[q] = row
    batch_members = 0
    for flight, lits in q1_batches().items():
        reqs = [engine.optimizer.optimize(compile_pql(
            Q1_TEMPLATES[flight].format(**lit))) for lit in lits]
        blocks = engine.executor.execute_batch(reqs, engine.segments)
        torch.cuda.synchronize()
        for lit, req, blk in zip(lits, reqs, blocks):
            resp = engine.reducer.reduce(req, [blk])
            check(flight, canon_response(flight, resp),
                  q1_revenue(pools, ids, flight, lit))
            batch_members += 1
    launches = K.launch_counts()
    cube = {label: eng.executor.path_counts["cube"]
            for label, eng in (("per_segment", engine),
                               ("stacked", st_engine))}
    if not cube["per_segment"] or not cube["stacked"]:
        raise AssertionError(f"no query took a star-tree cube: {cube}")
    for name in ("filter_mask", "masked_part_sums",
                 "masked_part_sums_batched"):
        if not launches[name]:
            raise AssertionError(f"{name} never launched on the storage "
                                 f"path: {launches}")
    for q, pql in SSB_PQLS.items():
        row = answered[q]
        for label, eng in (("per_segment", engine), ("stacked", st_engine)):
            ts = []
            for _ in range(args.repeats):
                t = time.perf_counter()
                eng.query(pql)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t) * 1e3)
            row[f"{label}_p50_ms"] = float(np.median(ts))
            row[f"{label}_samples_ms"] = ts
        emit({"phase": "ssb_store", "query": q, "check": "pass", **row})
    cubes = [c.n_groups for c in engine.segments[0].star_trees]
    emit({"phase": "ssb_store_summary", "scale_factor": args.store_sf,
          "rows": rows, "segments": args.segments, "seed": BENCH_SEED,
          "build_seconds": build_s, "load_seconds": load_s,
          "disk_bytes": sum(os.path.getsize(os.path.join(d, f))
                            for d in dirs for f in os.listdir(d)),
          "cubes_per_segment": len(cubes), "cube_groups_segment0": cubes,
          "cube_path_counts": cube,
          "path_counts": {"per_segment": dict(engine.executor.path_counts),
                          "stacked": dict(st_engine.executor.path_counts)},
          "stacked_routes": dict(st_engine.route_counts),
          "batch_members": batch_members,
          "device_bytes": sum(s.device_bytes() for s in engine.segments),
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


def synth_check(lanes, stack, keys, tables, dtypes):
    """K17 against its plain version: bit for bit on the last segment
    whole (its padding rows too) and the first SYNTH_CHECK_HEAD rows of
    every segment; the derived and part lanes exact functions of the base
    ids over the whole stack; then K17's time beside its plain version's
    and its bound. Returns the kernels-line entry."""
    from pinot_tpu_torch.ops import synth
    S, P = stack.n_real, stack.padded_docs
    device = tables.device
    head = torch.arange(min(P, SYNTH_CHECK_HEAD), device=device)
    index = torch.cat([(torch.arange(S, device=device)[:, None] * P +
                        head).reshape(-1),
                       torch.arange((S - 1) * P, S * P, device=device)])
    want = synth.synth_rows_plain(keys, tables, index)
    parts = stack.gather([("lo_revenue", "parts")])["lo_revenue.parts"]
    bad = [name for name in synth.SYNTH_LANES if not torch.equal(
        lanes[f"{name}.ids"].reshape(-1)[index].long(), want[name])]
    cost = lanes["lo_supplycost.raw"].reshape(-1)[index]
    if not torch.equal(cost.view(torch.int32),
                       want["lo_supplycost"].view(torch.int32)):
        bad.append("lo_supplycost")
    if not torch.equal(parts.reshape(parts.shape[0], -1)[:, index],
                       want["parts"]):
        bad.append("parts")
    if bad:
        raise AssertionError(f"ssb_synth disagrees with its plain version "
                             f"on {bad}")

    def ids(c):
        return lanes[f"{c}.ids"].long()
    ymn, brand = ids("d_yearmonthnum"), ids("p_brand1")
    derived = {"d_year": ymn // 12,
               "d_yearmonth": tables.ymn_to_ym.long()[ymn],
               "p_category": brand // 40, "p_mfgr": brand // 200}
    for side in ("c", "s"):
        nation = ids(f"{side}_city") // 10
        derived[f"{side}_nation"] = nation
        derived[f"{side}_region"] = tables.nation_region.long()[nation]
    bad = [c for c, v in derived.items() if not torch.equal(ids(c), v)]
    if not torch.equal(tables.part_table[:, ids("lo_revenue")], parts):
        bad.append("parts")
    if bad:
        raise AssertionError(f"synthesized lanes {bad} are not the functions "
                             "of their base ids")
    del derived, ymn, brand

    ms = time_ms(lambda: synth.ssb_synth(keys, tables, S, P, dtypes), reps=3)
    plain = time_ms(lambda: synth.ssb_synth_plain(keys, tables, S, P,
                                                  dtypes), reps=1, warmup=0)
    row_bytes = sum(torch.empty(0, dtype=dtypes[c]).element_size()
                    for c in synth.SYNTH_LANES) + 4 + parts.shape[0]
    t_bytes = S * P * row_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = S * P * SYNTH_OPS_PER_ROW / INT32_OPS_PER_S * 1e3
    b = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    emit({"phase": "ssb_synth_check", "kernel": "ssb_synth",
          "rows_checked": int(index.numel()), "rows": S * P, "ms": ms,
          "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1],
          "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
          "bytes_per_row": row_bytes, "ops_per_row": SYNTH_OPS_PER_ROW,
          "library_ms": None})
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound": b,
            "library_ms": None}


def run_ssb_synth(args):
    """Stage 2 of the JAX bench (bench.py:1046-1100) on the card: launch
    counts from 0, --synth-rows rows in --segments segments synthesized by
    make_ssb_device_stack (K17, seed 3), the ids pulled back for the numpy
    oracle, the 13 queries once over the stack through
    ShardedQueryExecutor.execute_stack, each checked, the counts read (K17
    and K1-K3 must have launched); then K17's check (synth_check) and p50s
    of --repeats. Returns the launch counts and K17's entry."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.parallel.sharded import ShardedQueryExecutor
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.reduce import BrokerReduceService
    from pinot_tpu_torch.tools.datagen import SynthStack, \
        make_ssb_device_stack, ssb_pools, ssb_synth_inputs
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, canon_response, check, \
        make_cpu_queries
    mesh = make_mesh()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    lanes, num_docs, plan_table, padded = make_ssb_device_stack(
        args.synth_rows, args.segments, mesh, seed=BENCH_SEED)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    stack = SynthStack(lanes, num_docs, plan_table, padded)
    t0 = time.perf_counter()
    per = args.synth_rows // args.segments
    ids = {name[:-4]: lanes[name][:, :per].cpu().numpy().reshape(-1)
           for name in lanes if name.endswith(".ids")}
    cost = lanes["lo_supplycost.raw"][:, :per].cpu().numpy().reshape(
        -1).astype(np.float64)
    pull_s = time.perf_counter() - t0
    oracle = make_cpu_queries(ssb_pools(BENCH_SEED), ids, cost)
    executor = ShardedQueryExecutor(mesh=mesh)
    optimizer, reducer = BrokerRequestOptimizer(), BrokerReduceService()
    requests = {q: optimizer.optimize(compile_pql(pql))
                for q, pql in SSB_PQLS.items()}

    def run(q):
        resp = reducer.reduce(requests[q], [executor.execute_stack(
            requests[q], stack)])
        torch.cuda.synchronize()
        return resp

    firsts, oracle_s = {}, 0.0
    for q in SSB_PQLS:
        t = time.perf_counter()
        resp = run(q)
        firsts[q] = (time.perf_counter() - t) * 1e3
        if resp.exceptions:
            raise AssertionError(f"{q}: {resp.exceptions}")
        t = time.perf_counter()
        check(q, canon_response(q, resp), oracle[q]())
        oracle_s += time.perf_counter() - t
    launches = K.launch_counts()
    path_peak = torch.cuda.max_memory_allocated()
    for name in ("ssb_synth", "filter_mask", "masked_part_sums",
                 "dense_group_aggregate"):
        if not launches[name]:
            raise AssertionError(f"{name} never launched on the synthesized "
                                 f"path: {launches}")
    del ids, cost, oracle
    keys, tables, dtypes = ssb_synth_inputs(BENCH_SEED, mesh[0])
    entry = synth_check(lanes, stack, keys, tables, dtypes)
    for q in SSB_PQLS:
        ts = []
        for _ in range(args.repeats):
            t = time.perf_counter()
            run(q)
            ts.append((time.perf_counter() - t) * 1e3)
        emit({"phase": "ssb_synth", "query": q, "check": "pass",
              "route": "stacked", "first_ms": firsts[q],
              "p50_ms": float(np.median(ts)), "samples_ms": ts})
    emit({"phase": "ssb_synth_summary", "rows": args.synth_rows,
          "segments": args.segments, "padded_rows_per_segment": padded,
          "seed": BENCH_SEED, "synth_seconds": synth_s,
          "pull_seconds": pull_s, "oracle_seconds": oracle_s,
          "device_bytes": stack.device_bytes(),
          "peak_device_bytes": path_peak,
          "peak_device_bytes_with_check": torch.cuda.max_memory_allocated(),
          "launches": {k: v for k, v in launches.items() if v}})
    return launches, entry


# ---------------------------------------------------------------------------
# The query server: ServerInstance over TCP (phases 24-27)
# ---------------------------------------------------------------------------

SERVER_CLIENTS = 16                 # client threads, one connection each
SERVER_WORKERS = 4                  # the scheduler's workers (the default)
#: the batched join_raw check's member counts
SERVER_JOIN_BATCH_SIZES = (2, 4, 8)
#: dim filters of the batched join_raw check's other members (beside
#: J2.1's and J2.3's dim sides)
SERVER_JOIN_CATEGORIES = ("MFGR#11", "MFGR#13", "MFGR#21", "MFGR#24",
                          "MFGR#32", "MFGR#45")
SERVER_EXCHANGE_REPEATS = 5


def stamp_content_names(segments, seed: int, rows: int) -> None:
    """In-memory segments were never sealed, so they carry no artifact
    CRC and the result cache would take none of their answers. Their
    content is a function of the generator's inputs (seed, rows, segment
    count and index), which name it as exactly as a CRC names a sealed
    artifact: stamp that name where the CRC goes."""
    for i, seg in enumerate(segments):
        if not seg.metadata.crc:
            seg.metadata.crc = f"ssb:{seed}:{rows}:{len(segments)}:{i}"


def server_requests(seed: int):
    """Each client's requests, [(flight, pql, Q1 literals or None)]: Q1.1,
    Q1.2 and Q1.3 with literals drawn from --seed (one shape a flight, so
    concurrent clients coalesce), then Q2.1-Q4.3 as the benchmark writes
    them."""
    from pinot_tpu_torch.tools.ssb import Q1_LITERALS, Q1_TEMPLATES, \
        SSB_PQLS
    rng = np.random.default_rng([seed, 12])
    out = []
    for _c in range(SERVER_CLIENTS):
        draws = [("q1.1", dict(Q1_LITERALS["q1.1"],
                               year=int(rng.integers(1992, 1999)))),
                 ("q1.2", dict(Q1_LITERALS["q1.2"],
                               ym=199400 + int(rng.integers(1, 13)))),
                 ("q1.3", dict(Q1_LITERALS["q1.3"],
                               week=int(rng.integers(1, 9))))]
        out.append([(f, Q1_TEMPLATES[f].format(**lits), lits)
                    for f, lits in draws] +
                   [(q, pql, None) for q, pql in SSB_PQLS.items()
                    if not q.startswith("q1")])
    return out


def q1_oracle(pools, ids):
    """fn(flight, literals) -> SUM(lo_revenue) of a Q1 flight at any value
    of its drawn literal (d_year, d_yearmonthnum or d_weeknuminyear), the
    others fixed at Q1_LITERALS: one pass a flight over the rows the fixed
    literals keep, revenue summed per value of the drawn column
    (float64 sums of integers below 2^53: exact)."""
    from pinot_tpu_torch.tools.ssb import Q1_LITERALS, _range_ids, _vid
    rev = pools["lo_revenue"].astype(np.float64)
    sums = {}
    for flight, col in (("q1.1", "d_year"), ("q1.2", "d_yearmonthnum"),
                        ("q1.3", "d_weeknuminyear")):
        lits = Q1_LITERALS[flight]
        d_lo, d_hi = _range_ids(pools, "lo_discount", lits["dlo"],
                                lits["dhi"])
        disc, qty = ids["lo_discount"], ids["lo_quantity"]
        mask = (disc >= d_lo) & (disc < d_hi)
        if flight == "q1.1":
            mask &= qty < _vid(pools, "lo_quantity", lits["qty"])
        else:
            q_lo, q_hi = _range_ids(pools, "lo_quantity", lits["qlo"],
                                    lits["qhi"])
            mask &= (qty >= q_lo) & (qty < q_hi)
            if flight == "q1.3":
                mask &= ids["d_year"] == _vid(pools, "d_year", lits["year"])
        sums[flight] = (col, np.bincount(
            ids[col][mask], weights=rev[ids["lo_revenue"][mask]],
            minlength=len(pools[col])))
    drawn = {"q1.1": "year", "q1.2": "ym", "q1.3": "week"}

    def answer(flight, lits):
        col, s = sums[flight]
        return float(s[_vid(pools, col, lits[drawn[flight]])])
    return answer


def _client_round(port: int, payloads):
    """One round: client c sends payloads[c] one after another on its own
    ServerConnection, all clients released at once. Returns
    ([[reply bytes]], [[ms]], wall seconds); the ms are the clients' own
    clocks around each request."""
    from pinot_tpu_torch.transport.tcp import EventLoopThread, \
        ServerConnection
    loop = EventLoopThread()
    conns = [ServerConnection("127.0.0.1", port) for _ in payloads]
    replies = [[None] * len(p) for p in payloads]
    ms = [[0.0] * len(p) for p in payloads]
    errors = []
    start = threading.Barrier(len(payloads) + 1)

    def client(c):
        try:
            start.wait(60)
            for i, raw in enumerate(payloads[c]):
                t = time.perf_counter()
                replies[c][i] = loop.run(conns[c].request(raw, timeout=300),
                                         timeout=320)
                ms[c][i] = (time.perf_counter() - t) * 1e3
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(payloads))]
    try:
        for t in threads:
            t.start()
        start.wait(60)
        t0 = time.perf_counter()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a server client never finished")
        if errors:
            raise AssertionError(f"server clients failed: {errors[:3]}")
    finally:
        for c in conns:
            loop.run(c.close(), timeout=30)
        loop.stop()
    return replies, ms, wall


def _check_reply(raw, flight, request, want):
    """A reply's DataTable reduced as the broker reduces it, held to the
    oracle's answer `want`."""
    from pinot_tpu_torch.common.datatable import DataTable
    from pinot_tpu_torch.query.reduce import BrokerReduceService
    from pinot_tpu_torch.tools.ssb import canon_response, check
    dt = DataTable.from_bytes(raw)
    if dt.exceptions:
        raise AssertionError(f"server {flight}: {dt.exceptions}")
    check(flight, canon_response(flight, BrokerReduceService().reduce(
        request, [dt.to_block()])), want)
    return dt


def run_server(segments, table, oracle, args):
    """Phase server: a ServerInstance on the card over the SSB segments,
    started with start(port=0), first per segment and then with
    mesh=make_mesh(), the default 2 ms batch window and 4 workers. 16
    client threads, each on its own ServerConnection, send their
    InstanceRequest bytes (server_requests) at once; every reply is held
    to the numpy oracle. Then the same round again (the result cache's
    hits). Reports per-flight p50 / p99, batchedDispatches, the batch
    occupancy distribution, cache hits, and K1's batched launches from
    launch counts set to 0 before the first round. Fails unless
    batchedDispatches > 0. Returns the launches of both instances'
    first rounds."""
    from pinot_tpu_torch.common.metrics import ServerMeter, ServerTimer
    from pinot_tpu_torch.common.request import InstanceRequest
    from pinot_tpu_torch.common.serde import instance_request_to_bytes
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.server import ServerInstance
    stamp_content_names(segments, args.seed, len(table.ids["d_year"]))
    t = time.perf_counter()
    q1 = q1_oracle(table.pools, table.ids)
    from pinot_tpu_torch.tools.ssb import Q1_LITERALS, q1_revenue
    for f in ("q1.1", "q1.2", "q1.3"):     # the fast oracle against the
        lits = Q1_LITERALS[f]               # per-query one, once a flight
        if abs(q1(f, lits) - q1_revenue(table.pools, table.ids, f, lits)) \
                > 1e-6 * max(1.0, q1(f, lits)):
            raise AssertionError(f"the Q1 oracle disagrees on {f}")
    wants = {}
    opt = BrokerRequestOptimizer()
    plan = server_requests(args.seed)
    requests = [[opt.optimize(compile_pql(pql)) for _f, pql, _l in cl]
                for cl in plan]
    for cl in plan:
        for f, pql, lits in cl:
            if (f, pql) not in wants:
                wants[(f, pql)] = q1(f, lits) if lits else oracle[f]()
    oracle_s = time.perf_counter() - t
    total = dict.fromkeys(K.launch_counts(), 0)
    for label, mesh in (("per_segment", None), ("stacked", make_mesh())):
        srv = ServerInstance(f"ssb_{label}", num_workers=SERVER_WORKERS,
                             mesh=mesh)
        tdm = srv.data_manager.table("lineorder", create=True)
        for seg in segments:
            tdm.add_segment(seg)
        try:
            port = srv.start(port=0)
            payloads = [[instance_request_to_bytes(InstanceRequest(
                request_id=next(_REQUEST_IDS), query=r)) for r in cl]
                for cl in requests]
            K.reset_launch_counts()
            replies, ms, wall = _client_round(port, payloads)
            torch.cuda.synchronize()
            launches = K.launch_counts()
            for k, v in launches.items():
                total[k] += v
            t = time.perf_counter()
            for c, cl in enumerate(plan):
                for i, (f, pql, _l) in enumerate(cl):
                    _check_reply(replies[c][i], f, requests[c][i],
                                 wants[(f, pql)])
            check_s = time.perf_counter() - t
            batched = srv.metrics.meter(ServerMeter.BATCHED_DISPATCHES).count
            occupancy = collections.Counter(
                int(x) for x in
                srv.metrics.timer(ServerTimer.BATCH_OCCUPANCY)._samples)
            hits0 = srv.metrics.meter(ServerMeter.RESULT_CACHE_HITS).count
            waits0 = srv.metrics.meter(ServerMeter.SINGLE_FLIGHT_WAITS).count
            again = [[instance_request_to_bytes(InstanceRequest(
                request_id=next(_REQUEST_IDS), query=r)) for r in cl]
                for cl in requests]
            replies2, ms2, wall2 = _client_round(port, again)
            for c, cl in enumerate(plan):
                for i, (f, pql, _l) in enumerate(cl):
                    _check_reply(replies2[c][i], f, requests[c][i],
                                 wants[(f, pql)])
            hits = srv.metrics.meter(ServerMeter.RESULT_CACHE_HITS).count
            flights = sorted({f for f, _p, _l in plan[0]})
            lat = {f: [ms[c][i] for c, cl in enumerate(plan)
                       for i, (g, _p, _l) in enumerate(cl) if g == f]
                   for f in flights}
            report = {
                "phase": "server", "path": label,
                "clients": SERVER_CLIENTS, "workers": SERVER_WORKERS,
                "batch_window_ms": srv.batch_window_ms,
                "requests": sum(len(cl) for cl in plan), "check": "pass",
                "wall_s": wall, "qps": sum(len(cl) for cl in plan) / wall,
                "p50_ms": {f: float(np.percentile(v, 50))
                           for f, v in lat.items()},
                "p99_ms": {f: float(np.percentile(v, 99))
                           for f, v in lat.items()},
                "batched_dispatches": batched,
                "batch_occupancy": dict(sorted(occupancy.items())),
                "batch_bypass": srv.metrics.meter(
                    ServerMeter.BATCH_BYPASS).count,
                "single_flight_waits": waits0,
                "cache_hits_first_round": hits0,
                "repeat_round_cache_hits": hits - hits0,
                "repeat_round_requests": sum(len(cl) for cl in plan),
                "repeat_round_p50_ms": float(np.median(
                    [x for row in ms2 for x in row])),
                "repeat_round_wall_s": wall2,
                "k1_batched_launches": launches["filter_mask_batched"],
                "launches": {k: v for k, v in launches.items() if v},
                "oracle_seconds": oracle_s, "check_seconds": check_s}
            emit(report)
            if batched <= 0:
                raise AssertionError(f"server {label}: no batched dispatch "
                                     f"({report})")
        finally:
            srv.stop()
    return total


def _segment_rows(table, names):
    """The rows of the SSB segments `names` (ssb_<i>, equal slices in
    order) as (ids, supplycost) for the numpy oracle."""
    n = len(table.ids["d_year"])
    per = n // len(table.segments)
    parts = []
    for name in names:
        i = int(name.rsplit("_", 1)[1])
        parts.append(slice(i * per, (i + 1) * per
                           if i < len(table.segments) - 1 else n))
    ids = {c: np.concatenate([a[s] for s in parts])
           for c, a in table.ids.items()}
    return ids, np.concatenate([table.supplycost[s] for s in parts])


def residency_watermark(n_segments: int) -> int:
    """server_residency's deployment setting for admission's
    promotion-backlog watermark: past its segment count, so that a
    backlog of hot segments off the card never browns queries out."""
    return n_segments + 1


def run_server_residency(segments, table, oracle, args):
    """Phase server_residency: a ServerInstance on the card whose
    device_bytes_budget is half the SSB table's ledgered bytes (the lanes
    the earlier phases uploaded: ids and part lanes), above what else the
    ledger holds. The lanes are dropped, each segment tracked and warmed
    through the residency manager (admission puts the ones past the
    budget on the host tier). The deployment sets admission's
    promotion-backlog watermark past the segment count
    (residency_watermark): under the default one, 4 hot segments
    off the card brown out every query to a deadline of twice the
    service-time estimate, and answers come back partial. What the
    default policy decides on this instance's backlog is read after the
    attach and after the rounds, beside how many answers took longer
    than its deadline (reported, not checked). The 13 queries run three
    times: over every segment, over the segments that landed on the
    host tier (the queries heat them: promotions, and demotions of the
    colder ones), over the others. Every answer must equal the numpy
    oracle of the rows it covers. Reports bytes per tier and the ledger before and
    after, demotions, promotions, cold hits, and the answer p50 by the
    tiers its segments ran on (the reply's profile: scan or host). The
    table's bytes are those of the lanes the 13 queries read, uploaded by
    one run of each before the lanes are dropped."""
    import gc
    from pinot_tpu_torch.common.metrics import MetricsRegistry, ServerMeter
    from pinot_tpu_torch.common.request import InstanceRequest
    from pinot_tpu_torch.common.serde import instance_request_to_bytes
    from pinot_tpu_torch.obs.residency import LEDGER
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.server import ServerInstance
    from pinot_tpu_torch.server.admission import AdmissionController
    from pinot_tpu_torch.server.residency_manager import TIERS
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, make_cpu_queries
    from pinot_tpu_torch.query.executor import ServerQueryExecutor
    opt = BrokerRequestOptimizer()
    # the table's lanes, as the 13 queries read them, on the card
    warm = ServerQueryExecutor()
    for pql in SSB_PQLS.values():
        warm.execute(opt.optimize(compile_pql(pql)), segments)
    gc.collect()
    table_name = segments[0].metadata.table_name
    table_bytes = LEDGER.table_kind_bytes().get((table_name, "scan"), 0)
    if table_bytes <= 0:
        raise AssertionError("the SSB table has no ledgered lanes")
    for seg in segments:
        seg.destroy()
    gc.collect()
    torch.cuda.empty_cache()
    other = LEDGER.total_bytes()
    budget = other + table_bytes // 2
    names = [s.segment_name for s in segments]
    watermark = residency_watermark(len(names))
    srv = ServerInstance("ssb_residency", num_workers=SERVER_WORKERS,
                         device_bytes_budget=budget,
                         promotion_backlog_watermark=watermark)

    def default_admission() -> dict:
        """What admission under the default watermark decides now."""
        ctl = AdmissionController(
            metrics=MetricsRegistry("server"), estimator=srv.estimator,
            num_workers=SERVER_WORKERS,
            backlog_fn=srv.residency.promotion_backlog)
        t = time.monotonic()
        d = ctl.admit("lineorder", "probe")
        ctl.release("probe")
        return {"promotion_backlog": srv.residency.promotion_backlog(),
                "watermark": ctl.PROMOTION_BACKLOG_WATERMARK,
                "brownout": d.brownout, "deadline_ms":
                None if d.deadline_s is None else (d.deadline_s - t) * 1e3}
    try:
        tdm = srv.data_manager.table("lineorder", create=True)
        for seg in segments:
            tdm.add_segment(seg)
            srv.residency.track("lineorder", seg)
            srv.residency.warm_device(seg.segment_name)
        attach = {n: srv.residency.tracked(n) for n in names}
        hosted = [n for n in names if attach[n] != "device"]
        resident = [n for n in names if attach[n] == "device"]
        tiers_before = {t: srv.residency.tier_bytes(t) for t in TIERS}
        ledger_before = LEDGER.total_bytes()
        emit({"phase": "server_residency_attach", "budget": budget,
              "table_ledgered_bytes": table_bytes, "other_ledgered_bytes":
              other, "tiers": attach, "tier_bytes": tiers_before,
              "ledger": ledger_before,
              "promotion_backlog": srv.residency.promotion_backlog()})
        if not hosted or not resident:
            raise AssertionError(f"the budget split no tiers: {attach}")
        default_at_attach = default_admission()
        oracles = {"all": oracle}
        for label, subset in (("host_at_attach", hosted),
                              ("device_at_attach", resident)):
            ids, cost = _segment_rows(table, subset)
            oracles[label] = make_cpu_queries(table.pools, ids, cost)
        by_tier = collections.defaultdict(list)
        rounds = []
        ledger_peak = ledger_before
        for label, subset in (("all", None), ("host_at_attach", hosted),
                              ("device_at_attach", resident)):
            for q, pql in SSB_PQLS.items():
                req = opt.optimize(compile_pql(pql))
                raw = instance_request_to_bytes(InstanceRequest(
                    request_id=next(_REQUEST_IDS), query=req,
                    search_segments=subset))
                t = time.perf_counter()
                reply = srv.handle_request_bytes(raw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                ledger_peak = max(ledger_peak, LEDGER.total_bytes())
                dt = _check_reply(reply, q, req, oracles[label][q]())
                paths = json.loads(dt.metadata["profileInfo"]).get(
                    "paths", {})
                kind = ("host" if not paths.get("scan") else
                        "device" if not paths.get("host") else "mixed")
                by_tier[kind].append(ms)
                rounds.append({"round": label, "query": q, "ms": ms,
                               "tiers": kind, "paths": paths})
        default_after = default_admission()
        cut = default_after["deadline_ms"]
        report = {
            "phase": "server_residency", "check": "pass",
            "promotion_backlog_watermark": watermark,
            "default_admission": {
                "at_attach": default_at_attach, "after": default_after,
                "answers_past_its_deadline": None if cut is None else
                sum(r["ms"] > cut for r in rounds)},
            "table_ledgered_bytes": table_bytes, "other_ledgered_bytes":
            other, "device_bytes_budget": budget,
            "attach_tiers": attach, "tier_bytes_after_attach": tiers_before,
            "tier_bytes_after": {t: srv.residency.tier_bytes(t)
                                 for t in TIERS},
            "final_tiers": {n: srv.residency.tracked(n) for n in names},
            "ledger_after_attach": ledger_before,
            "ledger_peak": ledger_peak,
            "ledger_after": LEDGER.total_bytes(),
            "demotions": srv.metrics.meter(ServerMeter.RESIDENCY_DEMOTIONS,
                                           table="host").count,
            "promotions": srv.metrics.meter(
                ServerMeter.RESIDENCY_PROMOTIONS, table="lineorder").count,
            "queries": len(rounds),
            "p50_ms_by_tiers": {k: float(np.median(v))
                                for k, v in sorted(by_tier.items())},
            "answers_by_tiers": {k: len(v)
                                 for k, v in sorted(by_tier.items())},
            "rounds": rounds}
        emit(report)
        return report
    finally:
        srv.stop()


def server_kernel_check(raw_seg, dim, j_pqls):
    """Phase server_kernel_check: K1's batched form with the join_raw
    leaf on the first raw-key segment, at B = 2, 4 and 8 members: J2.1's
    and J2.3's dim sides, then dim sides of other p_category filters, all
    padded to the members' largest Dp (by repeating their largest key, as
    JoinContext pads), each sorted by K12 once. Held (batch_case) to its
    plain version (torch.searchsorted per member) and to B single K1
    launches, bit for bit, masks and counts; launched once a call; timed
    at B = 8 with the L2 flushed beside 8 single launches, the plain
    version, one torch.searchsorted per member and its bound (the key
    lane once, B mask rows, the members' member map or B x Dp keys,
    whichever route the batch takes, and B counts). The batch's lane is
    made by its first call and cached (SortedKeys.batch_lane), so the
    time is the launch's. Returns its report."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.stages import join as jmod
    spec_join = compile_pql(j_pqls["J2.1"][0]).join
    filters = [j_pqls["J2.1"][1], j_pqls["J2.3"][1]] + [
        (lambda d, c=c: d["p_category"] == c) for c in SERVER_JOIN_CATEGORIES]
    lane = raw_seg.data_source("lo_partkey").device_raw_values()
    np_dtype = lane.cpu().numpy().dtype
    sides = []
    for f in filters:
        keep = np.asarray(f(dim))
        ctx = jmod.JoinContext(spec_join,
                               dim["p_partkey"][keep].astype(np.int64), {})
        sides.append(ctx.padded_keys(np_dtype))
    dp = max(len(k) for k in sides)
    sides = [np.concatenate([k, np.full(dp - len(k), k[-1], k.dtype)])
             for k in sides]
    members = [[K.SortedKeys(k)] for k in sides]
    for m in members:
        m[0].on(lane.device)             # K12's sorts, before the counts
    P, n = raw_seg.padded_docs, raw_seg.num_docs
    spec = ("pred", "join_raw", "lo_partkey", "raw", dp)
    cols = {"lo_partkey.raw": lane}
    sks = [m[0].on(lane.device)[0] for m in members]
    esz = lane.element_size()

    def join_lane_bytes(B):
        """Bytes of the lane the batched leaf reads for B members: their
        member map (a byte a key of their range), or their sorted keys
        (B x Dp)."""
        bm = K.join_member_map([m[0] for m in members[:B]], lane)
        return B * dp * esz if bm is None else bm.map.numel()

    def join_ops(B):
        """A member map: the range test a row, a shift and a mask a
        member; a probe: 17 compares and a final one a member."""
        bm = K.join_member_map([m[0] for m in members[:B]], lane)
        return B * P * 18 if bm is None else 2 * P + 2 * B * P
    r = batch_case(
        "filter_mask", "join_raw (raw key) J2.1, J2.3 and 6 category dim "
        "sides", lambda B: K.filter_mask_batched(P, spec, cols,
                                                 members[:B], n),
        lambda B: K.filter_mask_batched_plain(P, spec, cols, members[:B],
                                              n),
        lambda b: K.filter_mask(P, spec, cols, members[b], n),
        lambda B: P * esz + B * P + join_lane_bytes(B) + 4 * B,
        join_ops, singles_of=(0,),
        expect={"filter_mask_batched": 1,
                "filter_mask_batched[join_raw]": 1},
        library=lambda: [torch.searchsorted(sk, lane) for sk in sks],
        sizes=SERVER_JOIN_BATCH_SIZES)
    bm = K.join_member_map([m[0] for m in members], lane)
    r.update(dp=dp, dim_rows=[int(np.asarray(f(dim)).sum())
                              for f in filters],
             key_bytes=esz, rows=n, padded_rows=P,
             join_route="search" if bm is None else "member_map",
             member_map_bytes=None if bm is None else int(bm.map.numel()))
    emit({"phase": "server_kernel_check", **r})
    return r


def run_join_batch(raw_segs, dim_server, dim, raw_fact):
    """Phase join_batch: raw-key join members in one execute_batch, the
    JAX executor's batched join_raw path. Eight J0-shaped members (no
    GROUP BY: the K2 path), each a p_category dim filter and an
    lo_quantity bound of its own: stage 1 publishes each member's dim
    scan through the dim server, stage 2 attaches each member's
    JoinContext, and ServerQueryExecutor.execute_batch runs them over the
    raw-key segments with launch counts set to 0: members whose plans
    share a signature (Dp is in it) share one batched K1 a segment, its
    join_raw leaf probing each member's own keys. Every member must equal
    join_oracle. Returns the launches."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.executor import ServerQueryExecutor
    from pinot_tpu_torch.query.plan import InstancePlanMaker, \
        batch_signature
    from pinot_tpu_torch.query.reduce import BrokerReduceService
    from pinot_tpu_torch.query.stages import broker as stages_broker
    from pinot_tpu_torch.query.stages import join as jmod
    from pinot_tpu_torch.tools import datagen
    members = []
    for i, cat in enumerate(SERVER_JOIN_CATEGORIES + ("MFGR#12",
                                                      "MFGR#15")):
        qty = 20 + 2 * i
        pql = (_JOIN_SELECT + f" WHERE part.p_category = '{cat}' AND "
               f"lineorderj.lo_quantity < {qty}")
        req = compile_pql(pql)
        src = stage1_publish(dim_server, stages_broker.dim_scan_request(req),
                             f"join_batch.{i}")
        ctx = jmod.build_context(req.join, [src], jmod.fact_partition_info(
            raw_segs, req.join.fact_key))
        members.append((cat, qty, req, jmod.attach(req, ctx, raw_segs)))
    sigs = collections.Counter(
        batch_signature(InstancePlanMaker().make_segment_plan(
            raw_segs[0], r)) for _c, _q, _r, r in members)
    ex = ServerQueryExecutor()
    K.reset_launch_counts()
    t = time.perf_counter()
    blocks = ex.execute_batch([r for _c, _q, _r, r in members], raw_segs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = K.launch_counts()
    probe = datagen.join_probe(dim, raw_fact)
    for (cat, qty, req, _r), blk in zip(members, blocks):
        resp = BrokerReduceService().reduce(req, [blk])
        want = join_oracle_dict(dim, raw_fact,
                                lambda d, c=cat: d["p_category"] == c,
                                lambda f, q=qty: f["lo_quantity"] < q, [],
                                probe)
        for fi in range(2):
            if response_dict(resp, fi) != want[fi]:
                raise AssertionError(f"join_batch {cat} < {qty}: "
                                     f"aggregation {fi} differs from "
                                     "join_oracle")
    chunks = sum(-(-t // K.MAX_BATCH) for t in sigs.values() if t > 1)
    want_launches = chunks * len(raw_segs)
    got = launches["filter_mask_batched[join_raw]"]
    if not chunks or got != want_launches:
        raise AssertionError(f"join_batch: {got} batched join_raw launches,"
                             f" expected {want_launches} ({dict(sigs)})")
    emit({"phase": "join_batch", "members": len(members), "check": "pass",
          "signatures": len(sigs), "members_per_signature":
          sorted(sigs.values()), "segments": len(raw_segs), "ms": ms,
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


def run_server_exchange(fact_server, dim_server, dim, fact):
    """Phase server_exchange: two ServerInstances in one process. A (the
    dim server, started with start(port=0)) publishes J2.1's stage-1 dim
    scan; B (`fact_server`) holds the fact segments and runs stage 2 with
    A as its exchange source: once with a source that names only A's address (B
    fetches the block over TCP, an XCHG frame to A's QueryServer) and once
    with A's registry key (in process). Both answers must equal
    join_oracle and each other. Reports both stage-2 p50s of
    SERVER_EXCHANGE_REPEATS (the first, warm-up run apart)."""
    from pinot_tpu_torch.common.datatable import DataTable
    from pinot_tpu_torch.common.request import InstanceRequest
    from pinot_tpu_torch.common.serde import instance_request_to_bytes
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.reduce import BrokerReduceService
    from pinot_tpu_torch.query.stages import broker as stages_broker
    from pinot_tpu_torch.tools import datagen
    pql, dim_filter, fact_filter, gcols = JOIN_QUERIES["J2.1"]
    req = compile_pql(pql)
    src = stage1_publish(dim_server, stages_broker.dim_scan_request(req),
                         "server_exchange.0")
    tcp = {k: v for k, v in src.items() if k != "xkey"}
    want = join_oracle_dict(dim, fact, dim_filter, fact_filter, gcols,
                            datagen.join_probe(dim, fact))
    out = {}
    for label, source in (("tcp", tcp), ("in_process", src)):
        answers, ts = [], []
        for _ in range(SERVER_EXCHANGE_REPEATS + 1):
            raw = instance_request_to_bytes(InstanceRequest(
                request_id=next(_REQUEST_IDS), query=compile_pql(pql),
                exchange_sources=[source]))
            t = time.perf_counter()
            dt = DataTable.from_bytes(
                fact_server.handle_request_bytes(raw))
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
            if dt.exceptions:
                raise AssertionError(f"server_exchange {label}: "
                                     f"{dt.exceptions}")
            answers.append(BrokerReduceService().reduce(
                req, [dt.to_block()]))
        for resp in answers:
            for fi in range(2):
                if response_dict(resp, fi) != want[fi]:
                    raise AssertionError(
                        f"server_exchange {label}: aggregation {fi} "
                        "differs from join_oracle")
        out[label] = {"stage2_p50_ms": float(np.median(ts[1:])),
                      "first_ms": ts[0], "samples_ms": ts[1:]}
    report = {"phase": "server_exchange", "query": "J2.1",
              "check": "pass", "dim_rows": src["rows"],
              "fact_segments": fact_server.data_manager.num_segments(),
              **out}
    emit(report)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=int, default=10)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bb-rows", type=int, default=10_000_000)
    ap.add_argument("--bb-segments", type=int, default=4)
    ap.add_argument("--vec-rows", type=int, default=10_000_000)
    ap.add_argument("--vec-segments", type=int, default=4)
    ap.add_argument("--vec-dim", type=int, default=128)
    ap.add_argument("--vec-queries", type=int, default=5)
    ap.add_argument("--batch-repeats", type=int, default=3)
    ap.add_argument("--rt-rows", type=int, default=RT_FLUSH_ROWS)
    ap.add_argument("--rt-sealed", type=int, default=RT_SEALED_DEFAULT)
    ap.add_argument("--rt-repeats", type=int, default=RT_REPEATS_DEFAULT)
    ap.add_argument("--join-rows", type=int, default=JOIN_FACT_ROWS)
    ap.add_argument("--join-segments", type=int, default=JOIN_SEGMENTS)
    ap.add_argument("--join-dim-rows", type=int, default=JOIN_DIM_ROWS)
    ap.add_argument("--store-sf", type=int, default=1)
    ap.add_argument("--synth-rows", type=int, default=SYNTH_ROWS)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from pinot_tpu_torch import native
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import build
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.tools import baseball
    from pinot_tpu_torch.tools.datagen import make_ssb_segments
    from pinot_tpu_torch.query.executor import ServerQueryExecutor
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, canon_response, \
        make_cpu_queries
    from pinot_tpu_torch.tools.ssb import check as check_ssb

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    seconds = {}                    # wall seconds per phase, host clock

    t0 = time.perf_counter()
    libs = build.build_all()
    seconds["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds["build"],
          "dir": str(build.build_dir()),
          "libs": {s: str(p) for s, p in libs.items()},
          "ptxas": build.BUILD_INFO.get("ptxas", {}),
          "native_seglib": native.lib() is not None})

    # -- SSB, in memory ---------------------------------------------------
    rows = args.sf * ROWS_PER_SF
    t0 = time.perf_counter()
    table = make_ssb_segments(rows, args.segments, seed=args.seed)
    engine = QueryEngine(table.segments)                  # on the card
    oracle = make_cpu_queries(table.pools, table.ids, table.supplycost)
    seconds["data"] = time.perf_counter() - t0
    emit({"phase": "data", "scale_factor": args.sf, "rows": rows,
          "segments": args.segments,
          "padded_rows_per_segment": table.segments[0].padded_docs,
          "seconds": seconds["data"]})
    t0 = time.perf_counter()
    entries = kernel_check(engine.segments[0], SSB_PQLS)
    seconds["kernel_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssb_launches, ssb_rows = run_ssb(engine, oracle, args.repeats)
    seconds["ssb"] = time.perf_counter() - t0
    emit({"phase": "ssb_summary", "scale_factor": args.sf, "rows": rows,
          "queries_passed": len(SSB_PQLS),
          "device_table_bytes": sum(s.device_bytes()
                                    for s in engine.segments),
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": ssb_launches})
    # the same segments stacked: one launch per kernel over all of them
    st_engine = QueryEngine(engine.segments, mesh=make_mesh())
    t0 = time.perf_counter()
    stack = st_engine.sharded.stack_for(st_engine.segments)
    stack.gather(sorted({key for pql in SSB_PQLS.values() for key in
                         st_engine.sharded.plan_maker.make_segment_plan(
                             stack.plan_segment(), st_engine.optimizer
                             .optimize(compile_pql(pql))).needed_cols}))
    torch.cuda.synchronize()
    seconds["ssb_stack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stacked_entries = stacked_kernel_check(st_engine, SSB_PQLS)
    seconds["stacked_kernel_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssb_st_launches = run_ssb_stacked(st_engine, ssb_rows, oracle,
                                      args.repeats)
    seconds["ssb_stacked"] = time.perf_counter() - t0
    # the compacted group-by: its kernels on segment 0, then compaction on
    # beside off over SSB Q2.1-Q4.3 and the crowded sorted table
    t0 = time.perf_counter()
    compact_entries = compact_kernel_check(
        engine.segments[0], [(q, SSB_PQLS[q]) for q in COMPACT_SSB_CASES])
    seconds["group_compact_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    off_engine = QueryEngine(engine.segments)
    off_engine.executor = ServerQueryExecutor(
        InstancePlanMaker(allow_group_compaction=False))
    gc_launches, gc_routes = run_group_compact(
        "ssb", engine, off_engine, st_engine,
        [(q, p) for q, p in SSB_PQLS.items() if not q.startswith("q1")],
        lambda q, resp: check_ssb(q, canon_response(q, resp), oracle[q]()),
        CSUMS_RTOL, args.repeats)
    sorted_segs, sorted_rows = sorted_ssb_segments(table, CROWDED_SEGMENTS)
    crowded = crowded_expected(table, sorted_rows)

    def check_crowded(_name, resp):
        if _groups_of(resp) != crowded:
            raise AssertionError("the crowded group-by differs from its "
                                 "numpy answer")

    sorted_off = QueryEngine(sorted_segs)
    sorted_off.executor = off_engine.executor
    launches, routes = run_group_compact(
        "ssb_sorted", QueryEngine(sorted_segs), sorted_off,
        QueryEngine(sorted_segs, mesh=make_mesh()),
        [("crowded", CROWDED_PQL)], check_crowded, 0.0, args.repeats)
    if not routes["escalation"]:
        raise AssertionError(f"the crowded filter never escalated: {routes}")
    gc_launches = {k: v + launches[k] for k, v in gc_launches.items()}
    gc_routes.update(routes)
    del sorted_segs, sorted_off, off_engine
    seconds["group_compact"] = time.perf_counter() - t0
    emit({"phase": "ssb_stacked_summary", "segments": stack.n_real,
          "queries_passed": len(SSB_PQLS),
          "stack_seconds": seconds["ssb_stack"],
          "stack_device_bytes": stack.device_bytes(),
          "segment_device_bytes": sum(s.device_bytes()
                                      for s in engine.segments),
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": ssb_st_launches})
    # cross-query batches over the same segments
    t0 = time.perf_counter()
    batch_entries = batch_kernel_check_ssb(engine.segments[0])
    seconds["ssb_batch_kernel_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    families, check_member = ssb_batch_families(table)
    batch_launches = run_batch("ssb", engine, families, check_member,
                               args.batch_repeats)
    seconds["ssb_batch"] = time.perf_counter() - t0
    # the query server over the same segments: concurrent clients over
    # TCP, then the residency tiers under a byte budget
    del st_engine, stack
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    server_launches = run_server(engine.segments, table, oracle, args)
    seconds["server"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_server_residency(engine.segments, table, oracle,
                                            args)
    seconds["server_residency"] = time.perf_counter() - t0
    del engine, table, oracle
    torch.cuda.empty_cache()

    # -- the JAX bench's SSB path: cubes from disk, K17's 100M rows -------
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        t0 = time.perf_counter()
        store_launches = run_ssb_store(base, args)
        seconds["ssb_store"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    synth_launches, synth_entry = run_ssb_synth(args)
    seconds["ssb_synth"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # -- baseballStats, from disk -----------------------------------------
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        t0 = time.perf_counter()
        dirs, cols = baseball.build_segment_dirs(
            base, args.bb_rows, args.bb_segments, seed=args.seed)
        seconds["bb_data_build"] = time.perf_counter() - t0
        # the raw-key table: runs, hits and salary without a dictionary
        t0 = time.perf_counter()
        raw_dir, raw_cols = baseball.build_raw_key_dir(
            base, baseball.RAW_KEY_ROWS, seed=args.seed + args.bb_segments)
        seconds["bb_data_raw_key_build"] = time.perf_counter() - t0
        # the MV metric table: a numeric MV column
        t0 = time.perf_counter()
        mv_dir, mv_cols = baseball.build_mv_metric_dir(
            base, baseball.MV_METRIC_ROWS,
            seed=args.seed + args.bb_segments + 1)
        seconds["bb_data_mv_metric_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = QueryEngine.from_dirs(dirs)              # on the card
        raw_engine = QueryEngine.from_dirs([raw_dir])
        mv_engine = QueryEngine.from_dirs([mv_dir])
        seconds["bb_data_load"] = time.perf_counter() - t0
        emit({"phase": "bb_data", "rows": args.bb_rows,
              "segments": args.bb_segments,
              "padded_rows_per_segment": engine.segments[0].padded_docs,
              "raw_key_rows": baseball.RAW_KEY_ROWS,
              "mv_metric_rows": baseball.MV_METRIC_ROWS,
              "build_seconds": seconds["bb_data_build"],
              "raw_key_build_seconds": seconds["bb_data_raw_key_build"],
              "mv_metric_build_seconds": seconds["bb_data_mv_metric_build"],
              "load_seconds": seconds["bb_data_load"],
              "disk_bytes": sum(os.path.getsize(os.path.join(d, f))
                                for d in dirs + [raw_dir, mv_dir]
                                for f in os.listdir(d))})
        oracle = baseball.Oracle(cols)
        raw_oracle = baseball.Oracle(raw_cols)
        mv_oracle = baseball.Oracle(mv_cols)
        t0 = time.perf_counter()
        entries.update(bb_kernel_check(engine.segments[0],
                                       raw_engine.segments[0]))
        seconds["bb_kernel_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        entries.update(select_kernel_check(engine.segments[0]))
        seconds["select_kernel_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bb_launches, bb_seconds, bb_answered, bb_p50 = run_baseball(
            [(engine, oracle, list(baseball.all_draws(oracle))),
             (raw_engine, raw_oracle,
              [("raw_group_by", d) for d in
               baseball.raw_key_draws(raw_oracle)]),
             (mv_engine, mv_oracle,
              [("mv_metric", d) for d in
               baseball.mv_metric_draws(mv_oracle)])], args.repeats)
        seconds["baseball"] = time.perf_counter() - t0
        seconds.update({f"baseball_{k}": v for k, v in bb_seconds.items()})
        t0 = time.perf_counter()
        bb_st_engine = QueryEngine(engine.segments, mesh=make_mesh())
        bb_st_launches = run_baseball_stacked(
            bb_st_engine, bb_answered, oracle, args.repeats, bb_p50)
        seconds["baseball_stacked"] = time.perf_counter() - t0
        # the compacted group-by on baseballStats: the ranked layout (both
        # K16 routes) on segment 0, then the filtered group-by draws and
        # the ranked cases with compaction on beside off
        t0 = time.perf_counter()
        # K14 and K15 keep SSB Q2.1's entries (the SSB path's case); K16
        # and its sort route come from here
        for k, v in compact_kernel_check(
                engine.segments[0], list(BB_COMPACT_PQLS.items())).items():
            compact_entries.setdefault(k, v)
        seconds["bb_group_compact_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bb_cases = bb_compact_draws(oracle)
        off_engine = QueryEngine(engine.segments)
        off_engine.executor = ServerQueryExecutor(
            InstancePlanMaker(allow_group_compaction=False))
        launches, routes = run_group_compact(
            "baseball", engine, off_engine, bb_st_engine,
            [(i, d.pql) for i, d in enumerate(bb_cases)],
            lambda i, resp: baseball.check(resp, oracle, bb_cases[i]),
            baseball.FLOAT_RTOL, args.repeats)
        gc_launches = {k: v + launches[k] for k, v in gc_launches.items()}
        gc_routes.update(routes)
        del off_engine, bb_st_engine
        seconds["bb_group_compact"] = time.perf_counter() - t0
        missing = [k for k in ("block_compact", "slot_tables", "rank_slots",
                               "radix_sort_rank",
                               "dense_group_aggregate[idoff]",
                               "dense_group_aggregate[idrank]")
                   if not gc_launches[k]]
        missing += [r for r in ("scout", "hist", "idoff", "idrank",
                                "dense_regime", "compacted", "ranked",
                                "sorted", "escalation") if not gc_routes[r]]
        if missing:
            raise AssertionError(f"the compacted group-by never took "
                                 f"{missing}: {dict(gc_routes)}")
        emit({"phase": "group_compact_routes", "routes": dict(gc_routes)})
        t0 = time.perf_counter()
        batch_entries.update(batch_kernel_check_bb(engine.segments[0]))
        seconds["bb_batch_kernel_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        draws = baseball.batch_draws(oracle)
        launches = run_batch(
            "baseball", engine, {f: [d.pql for d in ds]
                                 for f, ds in draws.items()},
            lambda f, i, resp: baseball.check(resp, oracle, draws[f][i]),
            args.batch_repeats)
        batch_launches = {k: v + launches[k]
                          for k, v in batch_launches.items()}
        seconds["baseball_batch"] = time.perf_counter() - t0
    del engine, raw_engine, mv_engine
    torch.cuda.empty_cache()

    # -- VECTOR_SIMILARITY, from disk -------------------------------------
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        t0 = time.perf_counter()
        vec_engine, draws, vec_build_launches = vec_data(base, args)
        seconds["vec_data"] = time.perf_counter() - t0
        vec_st_engine = QueryEngine(vec_engine.segments, mesh=make_mesh())
        queries = draws.queries(args.vec_queries)
        t0 = time.perf_counter()
        vec_entries, vec_stacked = vector_kernel_check(
            vec_engine, vec_st_engine, queries[0])
        entries.update(vec_entries)
        stacked_entries.update(vec_stacked)
        seconds["vector_kernel_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vec_launches, vec_oracle, vec_exact = run_vector(
            vec_engine, vec_st_engine, queries, args, args.repeats)
        seconds["vector"] = time.perf_counter() - t0
        # 8 members: the script's query vectors and more drawn after them
        batch_queries = queries + draws.queries(
            max(0, K.MAX_BATCH - len(queries)))
        t0 = time.perf_counter()
        batch_entries.update(batch_kernel_check_vec(vec_engine.segments[0],
                                                    batch_queries))
        seconds["vec_batch_kernel_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        families, check_member = vec_batch_families(
            vec_engine, batch_queries, vec_oracle, vec_exact,
            sum(s.num_docs for s in vec_engine.segments))
        launches = run_batch("vecbench", vec_engine, families, check_member,
                             args.batch_repeats)
        batch_launches = {k: v + launches[k]
                          for k, v in batch_launches.items()}
        seconds["vector_batch"] = time.perf_counter() - t0
        emit({"phase": "vector_summary", "rows": args.vec_rows,
              "segment_device_bytes": sum(s.device_bytes()
                                          for s in vec_engine.segments),
              "stack_device_bytes": sum(
                  st.device_bytes()
                  for st in vec_st_engine.sharded._stacks.values()),
              "peak_device_bytes": torch.cuda.max_memory_allocated()})
        del vec_engine, vec_st_engine

    # -- multi-stage: lineorderj x part joins, window functions ----------
    from pinot_tpu_torch.server import ServerInstance
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        t0 = time.perf_counter()
        jsegs, raw_segs, dim_seg, dim, fact, raw_fact, _ = join_data(base,
                                                                     args)
        seconds["join_data"] = time.perf_counter() - t0
        # the part table's server (stage 1 of every join publishes there)
        # and the fact table's (stage 1 of the windows, stage 2 over TCP)
        dim_server = ServerInstance("Server_dim",
                                    num_workers=SERVER_WORKERS)
        dim_server.data_manager.table("part", create=True).add_segment(
            dim_seg)
        dim_server.start(port=0)
        fact_server = ServerInstance("Server_fact",
                                     num_workers=SERVER_WORKERS)
        for seg in jsegs:
            fact_server.data_manager.table(
                "lineorderj", create=True).add_segment(seg)
        try:
            t0 = time.perf_counter()
            join_launches, join_ctxs, _ = run_join(
                jsegs, raw_segs, dim_server, dim, fact, raw_fact,
                args.repeats)
            seconds["join"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            where, wrows = window_where(fact)
            window_launches, wcase = run_window(fact_server, jsegs, where,
                                                wrows, args.repeats)
            seconds["window"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            stage_entries = join_kernel_check(jsegs[0], raw_segs[0],
                                              join_ctxs["J2.1"], wcase)
            seconds["join_kernel_check"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            join_batch_entry = server_kernel_check(raw_segs[0], dim,
                                                   JOIN_QUERIES)
            seconds["server_kernel_check"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            join_batch_launches = run_join_batch(raw_segs, dim_server, dim,
                                                 raw_fact)
            seconds["join_batch"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            run_server_exchange(fact_server, dim_server,
                                                  dim, fact)
            seconds["server_exchange"] = time.perf_counter() - t0
        finally:
            dim_server.stop()
            fact_server.stop()
        del jsegs, raw_segs, dim_seg, dim, fact, raw_fact, join_ctxs, wcase
    torch.cuda.empty_cache()
    batch_launches = {k: v + server_launches[k] + join_batch_launches[k]
                      for k, v in batch_launches.items()}

    # -- realtime upserts: baseballStats_REALTIME -------------------------
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        t0 = time.perf_counter()
        rt_launches, launches, rt_summary = run_realtime(base, args)
        batch_launches = {k: v + launches[k]
                          for k, v in batch_launches.items()}
        seconds["realtime"] = time.perf_counter() - t0
        emit({"phase": "realtime_summary", **rt_summary,
              "seconds": seconds["realtime"],
              "peak_device_bytes": torch.cuda.max_memory_allocated()})
    unused = [k for k, v in batch_launches.items()
              if k.endswith("_batched") and not v]
    if unused:
        raise AssertionError(f"batched kernels never launched by the batch "
                             f"phases: {unused}")
    cuts = []
    if args.rt_sealed < RT_SEALED_FULL:
        cuts.append(f"realtime: {args.rt_sealed} sealed segment(s) of "
                    f"{args.rt_rows} rows before the consuming one, of "
                    f"the configuration's {RT_SEALED_FULL}")
    if args.rt_repeats < args.repeats:
        cuts.append(f"realtime: p50s of {args.rt_repeats} timed runs, not "
                    f"--repeats {args.repeats}")
    emit({"phase": "timing", "seconds": seconds,
          "total_seconds": time.perf_counter() - t_start, "cuts": cuts})

    print(smi, flush=True)
    line = []
    stage_launches = {k: join_launches.get(k, 0) + window_launches.get(k, 0)
                      for k in set(join_launches) | set(window_launches)}

    def path_launches(name: str) -> int:
        """Launches of `name` on every path run with counts from 0."""
        return (ssb_launches[name] + store_launches[name] +
                synth_launches[name] + bb_launches[name] +
                vec_build_launches[name] + vec_launches["per_segment"][name] +
                ssb_st_launches[name] + bb_st_launches[name] +
                vec_launches["stacked"][name] + batch_launches.get(name, 0) +
                rt_launches.get(name, 0) + stage_launches.get(name, 0) +
                gc_launches[name])

    for name, info in K.KERNELS.items():
        if name == "ssb_synth":
            e = synth_entry
            line.append({"name": name, "route": "cuda",
                         "source": info.source, "replaces": info.replaces,
                         "launches": synth_launches[name],
                         "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                         "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                         "bound_by": e["bound"][1],
                         "library_ms": e["library_ms"]})
            continue
        if name in COMPACT_KERNELS:
            e = compact_entries[name]
            line.append({"name": name, "route": "cuda",
                         "source": info.source, "replaces": info.replaces,
                         "launches": path_launches(name),
                         "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                         "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                         "bound_by": e["bound"][1],
                         "library_ms": e["library_ms"], "case": e["case"]})
            continue
        if name in STAGE_KERNELS:
            e = stage_entries[name]
            line.append({"name": name, "route": "cuda",
                         "source": info.source, "replaces": info.replaces,
                         "launches": stage_launches[name],
                         "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                         "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                         "bound_by": e["bound"][1],
                         "library_ms": e["library_ms"]})
            continue
        if name.endswith("_batched"):
            e = batch_entries[name[:-len("_batched")]]
            line.append({"name": name, "route": "cuda",
                         "source": info.source, "replaces": info.replaces,
                         "launches": batch_launches[name],
                         "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                         "plain_ms": e["plain_ms"],
                         "bound_ms": e["bound_ms"],
                         "bound_by": e["bound_by"],
                         "library_ms": e["library_ms"],
                         "batch_members": BATCH_SIZES[-1],
                         "b_single_ms": e["b_single_ms"],
                         "stacked_launches": None, "stacked_ms": None,
                         "stacked_s_sequential_ms": None,
                         "stacked_bound_ms": None})
            continue
        e, st = entries[name], stacked_entries[name]
        st_launches = ssb_st_launches[name] + bb_st_launches[name] + \
            vec_launches["stacked"][name]
        line.append({"name": name, "route": "cuda", "source": info.source,
                     "replaces": info.replaces,
                     "launches": path_launches(name),
                     "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                     "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                     "bound_by": e["bound"][1],
                     "library_ms": e["library_ms"],
                     "stacked_launches": st_launches,
                     "stacked_ms": st["ms"],
                     "stacked_s_sequential_ms": st["s_sequential_ms"],
                     "stacked_bound_ms": st["bound_ms"]})
    # K1's vdoc node, counted apart: the realtime phase's launches (per
    # segment, frozen prefixes and stacked; then batched)
    source = K.KERNELS["filter_mask"].source
    e, st = entries["filter_mask[vdoc]"], stacked_entries["filter_mask[vdoc]"]
    line.append({"name": "filter_mask[vdoc]", "route": "cuda",
                 "source": source, "replaces": "pinot_tpu/ops/kernels.py:112",
                 "launches": rt_launches["filter_mask[vdoc]"],
                 "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                 "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                 "bound_by": e["bound"][1], "library_ms": None,
                 "stacked_ms": st["ms"],
                 "stacked_s_sequential_ms": st["s_sequential_ms"],
                 "stacked_bound_ms": st["bound_ms"]})
    e = batch_entries["filter_mask[vdoc]"]
    line.append({"name": "filter_mask_batched[vdoc]", "route": "cuda",
                 "source": source, "replaces": "pinot_tpu/ops/kernels.py:112",
                 "launches": batch_launches["filter_mask_batched[vdoc]"],
                 "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                 "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                 "bound_by": e["bound_by"], "library_ms": None,
                 "batch_members": BATCH_SIZES[-1],
                 "b_single_ms": e["b_single_ms"]})
    # the join nodes of K1 and K3, counted apart: the join phase's launches
    source = {"filter_mask": K.KERNELS["filter_mask"].source,
              "dense_group_aggregate":
              K.KERNELS["dense_group_aggregate"].source}
    for name, replaces in (
            ("filter_mask[join_raw]", "pinot_tpu/ops/kernels.py:118"),
            ("dense_group_aggregate[jcode]", "pinot_tpu/ops/kernels.py:740"),
            ("dense_group_aggregate[jraw]", "pinot_tpu/ops/kernels.py:752")):
        e = stage_entries[name]
        line.append({"name": name, "route": "cuda",
                     "source": source[name.split("[")[0]],
                     "replaces": replaces,
                     "launches": join_launches[name],
                     "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                     "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                     "bound_by": e["bound"][1],
                     "library_ms": e["library_ms"]})
    # K3's adaptive remap keys, counted apart: every path's launches
    for remap, replaces in (("idoff", "pinot_tpu/ops/kernels.py:711"),
                            ("idrank", "pinot_tpu/ops/kernels.py:720")):
        name = f"dense_group_aggregate[{remap}]"
        e = compact_entries[name]
        line.append({"name": name, "route": "cuda",
                     "source": source["dense_group_aggregate"],
                     "replaces": replaces, "launches": path_launches(name),
                     "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                     "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                     "bound_by": e["bound"][1], "library_ms": None,
                     "case": e["case"]})
    # K1's batched join_raw leaf, counted apart: the join_batch phase's
    # launches (raw-key join members in one execute_batch)
    e = join_batch_entry
    line.append({"name": "filter_mask_batched[join_raw]", "route": "cuda",
                 "source": K.KERNELS["filter_mask"].source,
                 "replaces": "pinot_tpu/ops/kernels.py:118",
                 "launches": join_batch_launches[
                     "filter_mask_batched[join_raw]"],
                 "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                 "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                 "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                 "batch_members": SERVER_JOIN_BATCH_SIZES[-1],
                 "b_single_ms": e["b_single_ms"]})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
