#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Six paths of the port at real size: the Palgol main path on a Graph500
R-MAT of scale 22 (edgefactor 16), GNN serving of the four GNNs at their
published widths (graphsage-reddit, gat-cora and pna on an
ogb_products-sized graph, graphcast on the full_graph_sm shape, sampled
graphsage-reddit minibatches on a Reddit-sized graph), LM serving of
h2o-danube-1.8b and of the MoE deepseek-moe-16b at their published widths
and depths (4 requests, 6144-token prompts, 32 greedy decode steps each),
and AutoInt serving at its published widths (39 fields × 10⁶ rows × 16)
at the ``RECSYS_SHAPES`` serve shapes, and training of four of those
models (h2o-danube-1.8b, gat-cora, graphsage-reddit, AutoInt) at full
width, then a restart-and-replay drill of the h2o-danube trainer. What it does, in order, and fails
on the first thing that is wrong:

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel of ``src/repro_torch/csrc`` from the checkout (one ``nvcc``
   per source, all at once) into the ignored ``src/repro_torch/build/``,
   and checks one tile of each tensor-core flash product (S = Q·Kᵀ,
   O = P·V) against f32 torch (with ``--probe`` it stops there);
2. holds each kernel against its plain PyTorch version on the card over a
   sweep: ``gather_rows`` over dtypes (bool tables included), widths,
   negative/sentinel indices, N % 16 != 0 and ``idx`` views at storage
   offsets 0-3, each case on the route ``ops.route`` names by row length;
   ``segment_reduce`` over every combiner, widths, empty segments, masks,
   NaNs, dropped rows planted with NaN, a 200,000-row segment, segments
   ending on tile edges, 2^20 one-row segments, all-empty segments and
   values at odd storage offsets, plus a float sum of random values held
   to ``TOL`` · Σ|x| of a float64 sum, and repeated bit for bit; both at
   the GNN layers' widths on their wide routes (``gather_rows`` ``scalar``,
   ``segment_reduce`` ``cols``: f32 and bf16 rows of 8 to 1,433, a
   ``[V, 8, 8]`` table, int32 and bool rows, table views at storage
   offsets 1-3 with each gather's access width as the C entry reports it,
   sum/max/min masked and not, prod and every int32 and bool combiner,
   segments ending on the cols route's tile and chunk edges at each width,
   a 163,558-row segment among short ones at widths 8 to 512, random float
   sums at ``TOL`` · Σ|x|, a float sum repeated bit for bit);
   ``flash_attention`` over tests/test_kernels.py's ``TestFlashAttention``
   shapes (at scale 1 with f32 scores, as the TPU kernel, and at the
   model's scale with the scores rounded to bf16, as the model runs),
   rows with no key, ``scale ≠ 1`` and the model's shape (D = 80,
   32/8 heads, window 4096), plus bf16 cases at the tensor-core route's
   tile edges, NaN in the next kv head's rows, and D = 100 (each case
   must take the route its dtype and D name); ``embedding_bag`` over
   ``TestEmbeddingBag``'s shapes and ``BAG_SWEEP`` (odd D, table views at
   storage offsets 1-3, H = 0, weighted bf16 bags of 8, rows wider than a
   block) with weights, masks and ids −1, V and 2³¹−1, each case on the
   route the sweep names for it, as the C entry reports it, and both
   routes taken (exact for
   bags of at most one slot, else the f32/bf16 ``TOL`` of
   tests/test_kernels.py; flash besides row by row, ``FLASH_ROW``,
   relative to each row's norm);
3. drives the graph main path — ``compile_program`` → ``run_bsp`` — on the
   R-MAT (4.19 M vertices, 67 M directed edges; about twice that once
   symmetrised, the soc-LiveJournal1 class of graph): Shiloach-Vishkin
   (pull and push) and WCC on the symmetric graph, SSSP and PageRank on
   the directed weighted one, plus ``cp.run()`` for WCC, each against an
   independent host oracle (scipy components, Dijkstra, a float64 numpy
   PageRank) and each superstep count against the plan's cost model, every
   ``gather_rows`` launch on the vec route and every ``segment_reduce``
   launch on the rows route; then runs the same programs through the
   partitioned placement (``run_bsp(placement="partitioned")``, edge-balanced
   shards with halo exchange): one shard in this process (all five, a first
   and a warm run each) and, on the first four, ``RANKS`` gloo ranks on
   the one card sharing the partition by CUDA IPC (gloo stages the CUDA
   tensors through the host: a correctness run, not a communication time);
   every field bit-equal to the replicated run (PageRank's f32 sum within
   ``TOL``), the same supersteps, trips and frontiers, both graph kernels
   launched by this phase (counted apart from the main path, every launch
   on ``vec`` / ``rows``), with the partition's host seconds, halo sizes
   and S-V's request dedup printed; then times ``gather_rows`` at WCC's
   shape and over four index patterns and ``segment_reduce`` at WCC's,
   vertex 0's segment alone, a uniform degree and PageRank's f32 sum, and
   measures the card's busy share over one program run (with
   ``--graph-only`` it
   stops there and prints the graph kernels' rows; ``--kernel-shapes``
   builds and times only the two graph kernels over those shapes, and
   prints no result line);
3c. serves the GNNs (``gnn_path``), weights from ``init(seed)``, through
   ``data.pipeline`` and ``models.gnn.models``: ``gnn_full_batch`` at the
   ogb_products shape (R-MAT scale 22, 4,194,304 nodes, about 62 M
   symmetric edges, d_feat 100) → ``forward`` of graphsage-reddit (f32),
   gat-cora (f32) and pna (bf16); graphcast (16 layers × 512, bf16) on the
   full_graph_sm shape (4,096 nodes, d_feat 1,433); ``gnn_minibatches`` →
   ``sage_minibatch_forward`` for 8 batches of 1,024 seeds on a scale-18
   R-MAT with f32 features [N, 602] and half of Reddit's 114.6 M edges
   (``GNN_EDGE_CUT``: the host's build of all of them would take about
   100 s of this phase's budget of about 150 s). Each
   full-graph forward must launch ``gather_rows`` ``scalar`` and
   ``segment_reduce`` ``cols`` and is held to the same forward with both
   wrappers pointed at their plain versions (max|Δ| ≤ 1e-4 · max|out| in
   f32, 3e-2 in bf16); one minibatch is replayed from its seed, its
   masked neighbours looked up among the graph's in-edges on the host and
   its logits held to a float64 numpy forward; the two wide routes are
   timed at these shapes beside their bounds, plain versions and library
   calls (under 0.1 ms also their device time, from a CUDA graph;
   ``--gnn-only`` runs the wide-route checks and this phase alone, and
   prints no result line);
4. serves h2o-danube-1.8b (24 layers, d 2560, bf16, random weights from
   the seed) through ``repro_torch.launch.serve``: prefill then greedy
   decode over the ring-buffer cache (6144 > the 4096 window, so the window
   binds and the ring wraps). Checks: one layer's real q/k/v through the
   flash kernel against its plain version, row by row relative to each
   row's norm (and that this check fails the plain version with the window
   cut by one 64-key tile); each decode step's logits
   against one prefill over prompt + decoded tokens (teacher-forced), and
   the greedy tokens wherever that reference's top-2 margin exceeds the
   tolerance; exactly 24 flash launches per prefill, all on the
   tensor-core route;
4b. serves deepseek-moe-16b (28 layers, d 2048, 16 heads of 128, 64
   routed experts top-6 of width 1408 and 2 shared, 16.9 B parameters in
   bf16, random weights from the seed) through ``launch.serve`` with the
   same traffic, twice (the same tokens), and asserts the launches
   exactly: a prefill 28 ``flash_attention`` (all tensor-core), 56
   ``gather_rows`` ``scalar`` (dispatch in fill mode, combine read in
   clip mode) and 28 ``segment_reduce`` ``cols``; a decode step the same
   but no flash; none on ``vec`` or ``rows``. Prints ``moe_serve``
   (prefill and decode tokens/s, first and warm, peak GB, init seconds,
   the share of the prefill's expert slots dropped, from ``moe_ffn``'s
   counters) and ``device_busy`` of a prefill and of a decode step.
   Checks: (a) layer 0's real q/k/v (D = 128, causal) through flash
   against its plain version row by row, and the smallest window cut
   (64 keys, doubling) that the row check fails; (b) layer 0's MoE FFN on
   its real ``ln2`` input against the same FFN with both graph kernels'
   wrappers pointed at their plain versions (3e-2·max|y|), against a
   float64 oracle over 256 tokens, and its keep mask on the host (each
   expert keeps its first ``cap`` slots in (token, slot) order); (c) a
   second serve at ``capacity_factor = E/k`` (no slot dropped) against
   one teacher-forced prefill with the routing pinned to the served one
   (bf16 roundings flip near-tied experts between the two; the flips and
   their margins are printed), as the LM check does, on the dense
   attention path (2048-token prompts; there position 0, prefill against
   prefill, measures the rounding floor), and printed unchecked on the
   served flash path. Before (c) it times the three kernels at this
   path's shapes beside their bounds, plain versions and library calls
   (with ``--moe-only`` this phase runs alone after the build, and prints
   no result line);
5. serves AutoInt (random tables from the seed): ``serve_p99`` (batch 512)
   logits against an independent float64 numpy forward, ``serve_bulk``
   (batch 262,144), and ``retrieval_cand`` (one query, 10⁶ candidates)
   against a float64 numpy top-100; ``embedding_bag`` must have launched,
   every launch on its ``vec`` route;
6. times ``flash_attention`` and ``embedding_bag`` at those paths' shapes
   beside their bounds, their plain versions and the one PyTorch call
   that computes the same function (``embedding_bag``'s bound counts each
   distinct row once; ``--bag-shapes`` builds and times only
   ``embedding_bag`` over four shapes, and prints no result line).

7. trains (``train_path``), gradients on: first each backward against its
   plain twin on the card over a sweep (``check_backward_kernels``: the
   flash backward ``csrc/flash_attention_bwd.cu`` at D = 80 with 32/8
   heads, D = 128 with 16/16 and D = 72 and 40 (rounded up to 16 on the
   tensor-core route), S on its tile edges and past the window, bf16 and
   f32, with f32 scores and with the scores rounded to bf16 as the model
   rounds them, row by row within ``FLASH_ROW`` of the plain backward on
   the same inputs, each case on the route ``bwd_route`` names; the
   gather's and the bag's table gradients with a hub id 163,558 times,
   Zipf ids and dropped ids, exact for k/16 values, else within ``TOL`` · Σ|x| of a float64
   host sum; segment max/min with planted ties bit-equal to the CPU's;
   each run twice, bit-equal); then, through
   ``repro_torch.launch.train.build`` and its step (loss and gradients →
   cosine schedule → AdamW with f32 moments), ``TRAIN_STEPS`` steps of
   h2o-danube-1.8b at full width and depth (bf16, remat, 4 × 4,096
   tokens: ``train_4k``'s global batch of 256 cut to one card), gat-cora
   at the Cora shape, graphsage-reddit on sampled minibatches of the GNN
   phase's graph and AutoInt on ``train_batch`` (65,536 rows). Each: step
   0's loss and global gradient norm against the same with every kernel's
   plain version (``TRAIN_TOL``), the launches per route forward and
   backward exact, every loss finite and step 0's batch's loss lower
   after the steps; warm step ms, throughput, busy share, top kernels and
   peak GB printed. Then the backwards' rows: the flash backward at
   h2o-danube's training shape and at deepseek-moe's D = 128 against its
   bound and SDPA's backward (each first held row by row to its plain
   version and bit-equal when run twice), the composed gather, segment and
   bag backwards against theirs and ``index_add_``/``index_select``
   (``--train-only`` runs the build, the probe and this phase alone, and
   prints no result line; ``--flash-bwd`` runs the build, the probe, the
   flash backward's sweep and its two rows, then times what the fixed
   order of its dQ adds costs against a build without it
   (``FLASH_BWD_UNORDERED``), and prints no result line).
8. drills the supervised trainer (``ckpt_drill``): h2o-danube-1.8b at full
   width and depth as in 7, ``CKPT_STEPS`` plain steps as the reference
   (an async checkpoint written under its last steps, their ms against
   the warm ones'; ``compress_with_feedback`` over step 0's gradient, each
   leaf within scale/2), then through ``launch.train.Supervised`` a job
   that stops at step 3 with its checkpoint, and a fresh one to step 6
   with a failure injected at step 4: one restart, one retry, the replayed
   losses, the final parameters and moments and the step-6 checkpoint
   read back all bit-equal to the reference, the manifest keyed by the
   JAX tree's paths, every flash launch on the tensor cores; prints the
   checkpoint's GB, the host snapshot, write (GB/s), restore and load
   seconds (``--ckpt-drill`` runs the build, the probe and this phase
   alone, and prints no result line).

Each path's launch counters are set to 0 just before it is driven and read
just after. Every number is printed beside the card's name and power
limit. The line before the last is the kernel table as JSON; the last line
is ``{"ok": true, "device": {...}}``. Without a card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data sheet: HBM3 rate, the non-tensor-core f32 rate (also
#: used for int32 ops, the same units) and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
#: tests/test_kernels.py TOL
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
#: flash_attention per query row: ‖got − want‖ ≤ REL·‖want‖ + FLOOR·√D.
#: An attention row's norm shrinks as 1/√(keys kept), so at the prefill's
#: window an absolute TOL is the size of the output itself; the relative
#: bound is a few bf16 roundings (2⁻⁸ each), the floor a few ulps of the
#: smallest rows, for the rows that keep no key (exactly 0)
FLASH_ROW = {torch.float32: (1e-4, 1e-6), torch.bfloat16: (1e-2, 1e-4)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def ptxas_entries(log: str) -> dict:
    """``{entry: [registers, spill store bytes]}`` from a ``ptxas -v`` log,
    entries named by their mangled kernel and template arguments."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = re.search(r"(flash_\w+?|\w+?)(I.*?E)?E?v", m.group(1))
            cur = m.group(1)[:48] if name is None else name.group(0)[:48]
            out.setdefault(cur, [0, 0])
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[cur][1] = int(m.group(1))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            out[cur][0] = int(m.group(1))
    return out


def say(kind: str, card: str, **fields):
    print(kind, json.dumps({**fields, "card": card}), flush=True)


# -- 2. kernels against their plain versions ---------------------------------


def flash_rows(got, want):
    """Over every query row of ``[B, H, Sq, D]`` outputs: the largest
    ‖got − want‖ over its ``FLASH_ROW`` limit (above 1 fails), and the
    largest ‖got − want‖ / ‖want‖ over rows that keep a key."""
    rel, floor = FLASH_ROW[want.dtype]
    g, w = got.float(), want.float()
    err = (g - w).norm(dim=-1)
    ref = w.norm(dim=-1)
    worst = float((err / (rel * ref + floor * want.shape[-1] ** 0.5)).max())
    live = ref > 0
    return worst, float((err[live] / ref[live]).max()) if bool(live.any()) else 0.0


def flash_row_check(got, want, what: str) -> float:
    """Fails unless every row is within ``FLASH_ROW``; returns the largest
    row ratio ‖got − want‖ / ‖want‖."""
    worst, ratio = flash_rows(got, want)
    if not worst <= 1.0:
        raise AssertionError(f"flash_attention {what}: a row differs by {worst} of its "
                             f"limit (largest row ratio {ratio})")
    return ratio


def check_kernels(device, gen):
    """Each kernel against its plain version over a sweep; returns the
    number of cases per kernel and flash's largest row ratio per dtype."""
    cases = check_gather(device, gen)
    cases.update(check_segment_reduce(device, gen))
    cases.update(check_wide_routes(device, gen))
    model_cases, row_ratio = check_model_kernels(device, gen)
    cases.update(model_cases)
    sync(device)
    return cases, row_ratio


def gather_case(table, idx, fill, device, what):
    """One gather on ``device`` against the plain version on the host, and
    on the card the route the wrapper counted against ``ops.route`` and, on
    the scalar route, the access width the C entry reported against
    ``ops.access_bytes`` (kept in ``gather_rows.last_access_bytes``).
    Returns the route taken (``None`` off the card)."""
    from repro_torch.kernels import gather_rows, gather_rows_plain
    from repro_torch.kernels.gather_rows.ops import access_bytes, route

    t, i = table.to(device), idx.to(device)
    before = gather_rows.launches_vec
    got = gather_rows(t, i, fill)
    took = None
    if device.type == "cuda":
        took = "vec" if gather_rows.launches_vec > before else "scalar"
        if took != route(got[0].numel() if got.shape[0] else 1):
            raise AssertionError(f"gather_rows {what}: took {took}")
        want = access_bytes(t[0].numel() * t.element_size(), t.data_ptr(), got.data_ptr())
        if took == "scalar" and got.numel() and gather_rows.last_access_bytes != want:
            raise AssertionError(f"gather_rows {what}: {gather_rows.last_access_bytes}-byte "
                                 f"accesses, not {want}")
    if not torch.equal(got.cpu(), gather_rows_plain(table.cpu(), idx.cpu(), fill)):
        raise AssertionError(f"gather_rows {what}")
    return took


def check_gather(device, gen):
    """``gather_rows`` over dtypes, row widths (1, 5 = 20 bytes in f32, 8, 40),
    negative and sentinel ids in both modes, N around the warp's 32
    outputs, ``idx`` views at storage offsets 0-3 and bool tables; on the
    card every case must take the route ``ops.route`` names."""
    cases = {"gather_rows": 0, "gather_rows_vec": 0, "gather_rows_scalar": 0}

    def count(took):
        cases["gather_rows"] += 1
        if took is not None:
            cases[f"gather_rows_{took}"] += 1

    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
        for shape in ((1000,), (1000, 5), (500, 8), (300, 40), (70_000,)):
            table = torch.randn(shape, generator=gen) * 10
            table = (table > 0) if dt == torch.bool else table.to(dt)
            v = shape[0]
            idx = torch.randint(-2 * v, 2 * v, (7777,), generator=gen, dtype=torch.int32)
            idx[:4] = torch.tensor([-1, v, v + 1, -v - 1])  # negative, sentinel
            for fill in (None, True if dt == torch.bool else -3):
                count(gather_case(table, idx, fill, device, f"{dt} {shape} fill={fill}"))
            # idx views at storage offsets 0-3 and lengths around the runs
            base = torch.randint(-v - 2, v + 2, (100_020,), generator=gen, dtype=torch.int32)
            for off in range(4):
                for n in (1, 15, 16, 17, 127, 129, 100_003):
                    idx = base[off:off + n]
                    for fill in (None, False if dt == torch.bool else 7):
                        count(gather_case(table, idx, fill, device,
                                          f"{dt} {shape} idx view +{off} n={n} fill={fill}"))
    if device.type == "cuda" and not (cases["gather_rows_vec"] and cases["gather_rows_scalar"]):
        raise AssertionError("gather_rows: a route was never taken")
    return cases


def sorted_ids(lengths, n, dropped_below=0, dropped_above=0):
    """Sorted int32 segment ids with ``lengths[s]`` rows of segment ``s``
    and the given number of dropped ids (-1 before, n after)."""
    ids = torch.repeat_interleave(torch.arange(n, dtype=torch.int32),
                                  torch.as_tensor(lengths, dtype=torch.int64))
    return torch.cat([torch.full((dropped_below,), -1, dtype=torch.int32), ids,
                      torch.full((dropped_above,), n, dtype=torch.int32)])


def segment_values(dt, op, e, gen, width=1):
    """Values for ``op``: float sums of k/16 with |k| <= 16, so that every
    partial sum of up to 2^20 rows is exact in f32 and the kernel's order of
    summation cannot change a bit (the check is exact, and finds a row
    read twice or missed); products near 1; the rest spread over hundreds.
    :func:`sum_rounding` holds float sums of random values to ``TOL``."""
    vals = torch.randn((e, width) if width > 1 else (e,), generator=gen)
    if dt == torch.bool:
        return vals > 0
    if op == "prod":
        return (1.0 + 0.05 * vals).to(dt) if dt != torch.int32 else vals.sign().to(dt)
    if op == "sum" and dt.is_floating_point:
        return (vals * 8).round().clamp(-16, 16).div(16).to(dt)
    return (vals * 100).to(dt)


def segment_case(vals, ids, n, op, mask, device, what):
    """One segment reduction on ``device`` against the plain version: float
    prod at ``TOL``, the rest exactly (NaN where the plain one has NaN; float
    sums are of :func:`segment_values`' exact k/16, :func:`sum_rounding`
    holds sums of random values).
    On the card the route must be the one ``ops.route`` names."""
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.kernels import segment_reduce, segment_reduce_plain
    from repro_torch.kernels.segment_reduce.ops import route

    dt = vals.dtype
    before = segment_reduce.launches_rows
    got = segment_reduce(
        vals.to(device), ids.to(device), n, op,
        mask=None if mask is None else mask.to(device),
        offsets=segment_offsets(ids, n).to(device),
    ).cpu()
    if device.type == "cuda":
        took = "rows" if segment_reduce.launches_rows > before else "cols"
        if took != route(vals.shape[1] if vals.ndim > 1 else 1):
            raise AssertionError(f"segment_reduce {what}: took {took}")
    want = segment_reduce_plain(vals, ids, n, op, mask=mask)
    if dt in TOL and op == "prod":
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt],
                                   equal_nan=True, msg=lambda m: f"segment_reduce {what}: {m}")
    elif dt in TOL:  # sums of k/16 and min/max: exact, NaN where the plain one has NaN
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"segment_reduce {what}: {m}")
    elif not torch.equal(got, want):
        raise AssertionError(f"segment_reduce {what}")
    return got


def sum_rounding(lengths, device, gen, width=1, dt=torch.float32):
    """A masked float sum of random values (``randn`` × 100, rows of
    ``width`` in ``dt``) over segments of ``lengths`` on ``device`` against
    the float64 sum of the same rows: each segment's error at most
    ``TOL[dt]`` · Σ|x| over its rows, the kernel's and the plain version's
    alike (the order of summation differs, so the error's scale is the
    magnitude summed, not the result, which cancels). Returns each one's
    largest error in units of eps32 · Σ|x|."""
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.kernels import segment_reduce, segment_reduce_plain

    n = len(lengths)
    ids = sorted_ids(lengths, n, 3, 4)
    e = ids.shape[0]
    vals = (torch.randn((e,) if width == 1 else (e, width), generator=gen) * 100).to(dt)
    mask = torch.rand(e, generator=gen) < 0.8
    x = torch.where(mask.reshape((e,) + (1,) * (vals.ndim - 1)), vals, 0).double()
    ref = segment_reduce_plain(x, ids, n, "sum")
    mag = segment_reduce_plain(x.abs(), ids, n, "sum")
    eps = torch.finfo(torch.float32).eps
    errs = {}
    for who, got in (
        ("kernel", segment_reduce(vals.to(device), ids.to(device), n, "sum", mask=mask.to(device),
                                  offsets=segment_offsets(ids, n).to(device)).cpu()),
        ("plain", segment_reduce_plain(vals, ids, n, "sum", mask=mask)),
    ):
        err = (got.double() - ref).abs()
        if not bool((err <= TOL[dt] * mag).all()):
            raise AssertionError(f"segment_reduce {dt} sum of random values ({who}, width "
                                 f"{width}): error {float(err.max())} past TOL · Σ|x|")
        errs[who] = float((err / (eps * mag).clamp(min=1e-300)).max())
    return errs


def tile_edge_lengths(tile):
    """Segment lengths around the rows route's tiles of ``tile`` items (a
    segment of L rows is L + 1 items): ends on a tile's last item, on its
    first (the head partial of a tile that holds no row of it), one row,
    empty runs, and segments over two and three tiles."""
    return [tile - 1, tile - 1, tile, 0, 0, tile + 1, 1, 2 * tile - 2, 0, 2 * tile - 1,
            2 * tile, 3 * tile - 1, 3, tile - 1]


def check_segment_reduce(device, gen):
    """``segment_reduce`` over every dtype and combiner, widths 1, 3 and 40,
    ids in [-3, n+3) (rows outside ``[offsets[0], offsets[n])`` are planted
    with NaN: they must not be read), empty segments, masks and NaNs; then
    for one-element rows a 200,000-row segment among short ones, segments
    ending on tile edges, 2^20 one-row segments, all segments empty (rows
    all dropped, or none at all), values and mask at odd storage offsets,
    float sums of random values against a float64 sum, and a float sum
    repeated bit for bit."""
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.kernels import segment_reduce
    from repro_torch.kernels.segment_reduce.ops import kernel_tiling

    tile = kernel_tiling(1)[0] if device.type == "cuda" else 16  # the CPU has no tiles
    cases = {"segment_reduce": 0}
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
        ops = ("min", "max", "or", "and") if dt == torch.bool else ("sum", "prod", "min", "max")
        for op in ops:
            for width in (1, 3, 40):
                n, e = 600, 9000
                ids = torch.randint(-3, n + 3, (e,), generator=gen, dtype=torch.int32)
                ids[(ids > 100) & (ids < 140)] = 150  # empty segments
                ids = torch.sort(ids).values
                vals = segment_values(dt, op, e, gen, width)
                if dt.is_floating_point:  # a NaN must reach its segment's result
                    vals.view(e, -1)[torch.randint(0, e, (5,), generator=gen), 0] = float("nan")
                    vals[(ids < 0) | (ids >= n)] = float("nan")  # dropped rows: never read
                for mask in (None, torch.rand(e, generator=gen) < 0.8):
                    segment_case(vals, ids, n, op, mask, device, f"{dt} {op} width={width}")
                    cases["segment_reduce"] += 1
            hub = [int(x) for x in torch.randint(0, 40, (50,), generator=gen)]
            hub[7] = 200_000
            for what, lengths, below, above in (
                ("a 200,000-row segment", hub, 5, 9),
                ("segments on tile edges", tile_edge_lengths(tile), 0, 0),
                ("2^20 one-row segments", [1] * 2**20, 2, 0),
                ("all empty, rows dropped", [0] * 3000, 40, 60),
                ("all empty, no rows", [0] * 3000, 0, 0),
            ):
                n = len(lengths)
                ids = sorted_ids(lengths, n, below, above)
                e = ids.shape[0]
                vals = segment_values(dt, op, e, gen)
                if dt.is_floating_point:
                    vals[(ids < 0) | (ids >= n)] = float("nan")
                for mask in (None, torch.rand(e, generator=gen) < 0.8):
                    segment_case(vals, ids, n, op, mask, device, f"{dt} {op}: {what}")
                    cases["segment_reduce"] += 1
            # values and mask as views at odd storage offsets
            ids = sorted_ids(hub, 50, 5, 9)
            e = ids.shape[0]
            vals = segment_values(dt, op, e + 3, gen)[3:]
            mask = (torch.rand(e + 5, generator=gen) < 0.8)[5:]
            segment_case(vals, ids, 50, op, mask, device, f"{dt} {op}: odd storage offsets")
            cases["segment_reduce"] += 1
    # float sums of random values: rounding held to TOL · Σ|x| of a float64 sum
    cases["segment_reduce_f32_sum_max_err_eps"] = {
        what: sum_rounding(lengths, device, gen)
        for what, lengths in (("200,000-row segment", hub),
                              ("tile edges", tile_edge_lengths(tile)),
                              ("uniform 1-40 rows", [int(x) for x in torch.randint(
                                  1, 41, (3000,), generator=gen)]))
    }
    # a float sum is the same bits from launch to launch
    ids = sorted_ids(hub, 50, 5, 9)
    vals = torch.randn(ids.shape[0], generator=gen).to(device)
    off = segment_offsets(ids, 50).to(device)
    first = segment_reduce(vals, ids.to(device), 50, "sum", offsets=off)
    for _ in range(3):
        again = segment_reduce(vals, ids.to(device), 50, "sum", offsets=off)
        if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
            raise AssertionError("segment_reduce: a float sum changed bits from one launch to the next")
    cases["segment_reduce_repeat_bitwise"] = 3
    return cases


#: the GNN layers' row widths: GAT's 8 heads (and 8 × 8 = 64), PNA's 75
#: and the ogb_products features' 100, GraphSAGE's 128, GraphCast's 512
GNN_WIDTHS = (8, 64, 75, 100, 128, 512)
#: rows past the cols route's 512-column slice (in slices, each row's piece
#: staged apart): the minibatch features' 602, the full_graph_sm features'
#: 1,433
SLICED_WIDTHS = (602, 1433)
#: vertex 0's in-degree in the main path's scale-22 R-MAT (PERF.md §4)
HUB_ROWS = 163_558


def check_wide_routes(device, gen):
    """The two graph kernels at the GNN shapes, on their wide routes
    (``gather_rows`` ``scalar``, ``segment_reduce`` ``cols``), each case
    against its plain version: f32 and bf16 rows of every ``GNN_WIDTHS``
    and ``SLICED_WIDTHS`` width and a ``[V, 8, 8]`` table, int32 and bool
    rows, table views at storage offsets 1-3, gathered in both index modes
    (negative and sentinel ids included; each case's access width, as the C
    entry reports it, must be ``ops.access_bytes``'s and is listed);
    sum/max/min over them with and without a mask (sums of k/16 and
    min/max exactly); segments ending on the edges of the cols route's
    tiles and of its chunks at every width; one ``HUB_ROWS``-row segment
    among short ones at widths 8, 64 and 100 (f32), 75 and 512 (bf16);
    prod in f32/bf16, every int32 and bool combiner at widths 8, 75 and
    512; float sums of random values held to ``TOL`` · Σ|x| of a float64
    sum; and a float sum on the cols route repeated bit for bit."""
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.kernels import gather_rows, segment_reduce
    from repro_torch.kernels.segment_reduce.ops import kernel_tiling

    on_card = device.type == "cuda"
    cases = {"gather_rows_wide": 0, "segment_reduce_wide": 0, "gather_rows_wide_access": {}}

    def gather(table, idx, fill, what):
        took = gather_case(table, idx, fill, device, what)
        if on_card and took != "scalar":
            raise AssertionError(f"gather_rows {what}: took {took}")
        cases["gather_rows_wide"] += 1
        if on_card:
            cases["gather_rows_wide_access"][what.split(" fill=")[0]] = gather_rows.last_access_bytes

    def seg(vals, ids, n, op, mask, what):
        segment_case(vals, ids, n, op, mask, device, what)
        cases["segment_reduce_wide"] += 1

    shapes = [(700, w) for w in GNN_WIDTHS] + [(700, 8, 8)]
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            table = (torch.randn(shape, generator=gen) * 10).to(dt)
            idx = torch.randint(-700, 1400, (5000,), generator=gen, dtype=torch.int32)
            idx[:4] = torch.tensor([-1, 700, 701, -701])
            for fill in (None, -3):
                gather(table, idx, fill, f"{dt} {shape} fill={fill}")
        for op in ("sum", "max", "min"):
            for shape in shapes:
                n, e = 600, 9000
                ids = torch.randint(-3, n + 3, (e,), generator=gen, dtype=torch.int32)
                ids[(ids > 100) & (ids < 140)] = 150  # empty segments
                ids = torch.sort(ids).values
                width = int(np.prod(shape[1:]))
                vals = segment_values(dt, op, e, gen, width).reshape((e,) + shape[1:])
                vals[(ids < 0) | (ids >= n)] = float("nan")  # dropped rows: never read
                for mask in (None, torch.rand(e, generator=gen) < 0.8):
                    seg(vals, ids, n, op, mask, f"{dt} {op} {shape[1:]}")
            hub = [int(x) for x in torch.randint(0, 40, (50,), generator=gen)]
            hub[7] = HUB_ROWS
            ids = sorted_ids(hub, 50, 5, 9)
            for width in ((8, 100) if dt == torch.float32 else (75,)):
                vals = segment_values(dt, op, ids.shape[0], gen, width)
                vals[(ids < 0) | (ids >= 50)] = float("nan")
                for mask in (None, torch.rand(ids.shape[0], generator=gen) < 0.8):
                    seg(vals, ids, 50, op, mask,
                        f"{dt} {op}: a {HUB_ROWS}-row segment, width {width}")
    hub = [int(x) for x in torch.randint(0, 40, (50,), generator=gen)]
    hub[7] = HUB_ROWS
    uniform = [int(x) for x in torch.randint(1, 41, (1000,), generator=gen)]
    cases["segment_reduce_wide_sum_max_err_eps"] = {
        f"{what} {str(dt)[6:]} width {width}": sum_rounding(lengths, device, gen, width, dt)
        for what, lengths, width, dt in (
            ("hub", hub, 100, torch.float32), ("hub", hub, 75, torch.bfloat16),
            ("uniform 1-40 rows", uniform, 512, torch.float32),
            ("uniform 1-40 rows", uniform, 8, torch.bfloat16))
    }

    # gathers: rows past a slice, int32 and bool rows, table views off alignment
    for dt, shape in ((torch.float32, (300, 602)), (torch.bfloat16, (200, 1433)),
                      (torch.int32, (700, 3)), (torch.int32, (700, 100)),
                      (torch.bool, (700, 5)), (torch.bool, (700, 64))):
        table = torch.randn(shape, generator=gen) * 10
        table = (table > 0) if dt == torch.bool else table.to(dt)
        idx = torch.randint(-shape[0], 2 * shape[0], (3001,), generator=gen, dtype=torch.int32)
        for fill in (None, True if dt == torch.bool else -3):
            gather(table, idx, fill, f"{dt} {shape} fill={fill}")
    for dt, width in ((torch.float32, 100), (torch.bfloat16, 75), (torch.float32, 602),
                      (torch.bfloat16, 512), (torch.float32, 8), (torch.bfloat16, 8)):
        values = (torch.randn((700, width), generator=gen) * 10).to(dt).to(device)
        idx = torch.randint(-700, 1400, (4001,), generator=gen, dtype=torch.int32)
        for off in (1, 2, 3):  # a table pointer 4-12 (f32) or 2-6 (bf16) bytes off 16
            view = table_view(values, off)
            for fill in (None, -3):
                gather(view, idx, fill, f"{dt} (700, {width}) table view +{off} fill={fill}")

    # segments on the cols route's tile and chunk edges at every width
    for width in GNN_WIDTHS + SLICED_WIDTHS:
        for dt in (torch.float32, torch.bfloat16):
            tile, chunks = kernel_tiling(width, dt) if on_card else (64, 8)
            for edge, t in (("tile", tile), ("chunk", tile // chunks)):
                lengths = tile_edge_lengths(t)
                n = len(lengths)
                ids = sorted_ids(lengths, n, 2, 3)
                e = ids.shape[0]
                for op in ("sum", "max"):
                    vals = segment_values(dt, op, e, gen, width)
                    vals[(ids < 0) | (ids >= n)] = float("nan")
                    for mask in (None, torch.rand(e, generator=gen) < 0.8):
                        seg(vals, ids, n, op, mask,
                            f"{dt} {op} width {width}: segments on {edge} edges ({t} items)")
    # the hub at widths 8, 64 (f32) and 512 (bf16)
    ids = sorted_ids(hub, 50, 5, 9)
    for dt, width in ((torch.float32, 8), (torch.float32, 64), (torch.bfloat16, 512)):
        for op in ("sum", "max"):
            vals = segment_values(dt, op, ids.shape[0], gen, width)
            vals[(ids < 0) | (ids >= 50)] = float("nan")
            seg(vals, ids, 50, op, torch.rand(ids.shape[0], generator=gen) < 0.8,
                f"{dt} {op}: a {HUB_ROWS}-row segment, width {width}")
    # prod, and every int32 and bool combiner on wide rows
    for dt, ops in ((torch.float32, ("prod",)), (torch.bfloat16, ("prod",)),
                    (torch.int32, ("sum", "prod", "min", "max")),
                    (torch.bool, ("min", "max", "or", "and"))):
        for op in ops:
            for width in (8, 75, 512):
                n, e = 600, 9000
                ids = torch.sort(torch.randint(-3, n + 3, (e,), generator=gen,
                                               dtype=torch.int32)).values
                vals = segment_values(dt, op, e, gen, width)
                if dt.is_floating_point:
                    vals[(ids < 0) | (ids >= n)] = float("nan")
                for mask in (None, torch.rand(e, generator=gen) < 0.8):
                    seg(vals, ids, n, op, mask, f"{dt} {op} width {width}")
    # a float sum on the cols route is the same bits from launch to launch
    ids = sorted_ids(hub, 50, 5, 9)
    off = segment_offsets(ids, 50).to(device)
    for dt, width in ((torch.float32, 100), (torch.bfloat16, 75)):
        vals = (torch.randn((ids.shape[0], width), generator=gen) * 100).to(dt).to(device)
        first = segment_reduce(vals, ids.to(device), 50, "sum", offsets=off)
        for _ in range(3):
            again = segment_reduce(vals, ids.to(device), 50, "sum", offsets=off)
            if not torch.equal(first.view(torch.int16), again.view(torch.int16)):
                raise AssertionError(f"segment_reduce cols: a {dt} sum of width {width} "
                                     "changed bits from one launch to the next")
    cases["segment_reduce_wide_repeat_bitwise"] = 6
    return cases


#: tests/test_kernels.py TestFlashAttention's shapes (b, h, hkv, sq, sk, d,
#: causal, window), rows with no key (window past the last key), and the
#: h2o-danube prefill's head shape (D = 80, 32/8 heads, window 4096)
FLASH_CASES = [
    (2, 4, 2, 64, 64, 32, True, None),
    (1, 2, 2, 48, 80, 16, True, 16),
    (2, 8, 4, 33, 57, 64, False, None),
    (1, 4, 1, 128, 128, 128, True, 32),
    (1, 1, 1, 8, 256, 64, True, None),
    (1, 2, 1, 100, 10, 8, False, 5),
    (1, 2, 1, 100, 10, 8, True, 5),
    (1, 32, 8, 4500, 4500, 80, True, 4096),
]
#: the tensor-core route's one-tile probe: (D, Sq, Sk) — the model's D,
#: rows past Sq/Sk that must read as zero, D % 16 != 0, the widest D
TC_PROBE_CASES = [(80, 128, 128), (80, 64, 100), (8, 64, 128), (128, 128, 77)]


def tc_probe(gen):
    """One tile of each tensor-core product (S = Q·Kᵀ, O = P·V) against
    f32 torch, before any whole kernel runs: the ``wgmma`` descriptors and
    the TMA swizzle must agree, or both products come out scrambled.
    Returns the largest error over each case's largest |value|."""
    from repro_torch.kernels.flash_attention.ops import TC_BLOCK_K, tile_probe

    worst = 0.0
    for d, sq, sk in TC_PROBE_CASES:
        q, k, v = (torch.randn((n, d), generator=gen).to(torch.bfloat16).cuda()
                   for n in (sq, sk, sk))
        p = torch.rand((64, TC_BLOCK_K), generator=gen).to(torch.bfloat16).cuda()
        s, o = tile_probe(q, k, v, p)
        torch.cuda.synchronize()
        qz = torch.zeros((64, d), device="cuda")
        qz[:min(sq, 64)] = q[:64].float()
        kz = torch.zeros((TC_BLOCK_K, d), device="cuda")
        kz[:min(sk, TC_BLOCK_K)] = k[:TC_BLOCK_K].float()
        vz = torch.zeros((TC_BLOCK_K, d), device="cuda")
        vz[:min(sk, TC_BLOCK_K)] = v[:TC_BLOCK_K].float()
        for name, got, want in (("Q·Kᵀ", s, qz @ kz.T), ("P·V", o, p.float() @ vz)):
            err = float((got - want).abs().max() / want.abs().max())
            if not err <= 1e-5:  # f32 sums of exact bf16 products
                raise AssertionError(f"tensor-core tile {name} at D={d}, Sq={sq}, "
                                     f"Sk={sk}: error {err} of the largest value")
            worst = max(worst, err)
    return worst


#: bf16 only, the tensor-core route's edges at its 128 x 128 tiles: Sq of
#: 1, 127, 129 and 6144; Sk below, at and past one key tile; windows of
#: 127, 128 and 129; D from 8 to 128; Hkv of 1 and H; and D = 100, which
#: takes the SIMT route
FLASH_BF16_CASES = [
    (1, 4, 1, 1, 100, 80, True, None),
    (1, 8, 1, 1, 129, 64, False, None),
    (1, 4, 4, 127, 127, 80, True, 127),
    (2, 4, 2, 129, 129, 64, True, 128),
    (1, 4, 1, 129, 500, 96, False, 129),
    (1, 2, 1, 200, 200, 8, True, None),
    (2, 2, 1, 300, 257, 16, False, None),
    (1, 2, 2, 255, 129, 128, True, None),
    (1, 4, 1, 6144, 6144, 80, True, 4096),
    (1, 2, 2, 6144, 6144, 128, True, 129),
    (1, 4, 2, 129, 129, 100, True, 128),
]
#: tests/test_kernels.py TestEmbeddingBag's shapes (v, d, b, h)
BAG_CASES = [(100, 16, 8, 4), (1000, 64, 16, 1), (50, 128, 4, 10)]
#: embedding_bag's route sweep (dtype, v, d, b, h, storage offset of the
#: table view in elements, the route the C entry must take): the scalar
#: route (odd D, views at offsets 1-3, bags of H != 1 slots: H = 0,
#: weighted bf16 bags of 8), the vec route (one-slot bags of f32 D = 16,
#: bf16 D = 8 and 64), blocks of bags with a ragged last one, and rows
#: wider than a block (blockIdx.y) on both routes;
#: tests/test_torch_kernels.py holds the plain version to the JAX package
#: over the same shapes
BAG_SWEEP = [
    ("float32", 40, 3, 9, 2, 0, "scalar"), ("float32", 40, 17, 9, 1, 0, "scalar"),
    ("bfloat16", 40, 12, 9, 3, 0, "scalar"),
    ("float32", 40, 16, 9, 1, 1, "scalar"), ("float32", 40, 16, 9, 2, 2, "scalar"),
    ("float32", 40, 16, 9, 3, 3, "scalar"), ("bfloat16", 40, 8, 9, 1, 1, "scalar"),
    ("bfloat16", 40, 8, 9, 2, 3, "scalar"),
    ("float32", 40, 16, 9, 1, 0, "vec"), ("bfloat16", 40, 8, 9, 1, 0, "vec"),
    ("bfloat16", 40, 64, 9, 4, 0, "scalar"),
    ("float32", 40, 16, 9, 0, 0, "scalar"), ("bfloat16", 40, 8, 9, 0, 0, "scalar"),
    ("bfloat16", 40, 64, 9, 8, 0, "scalar"), ("bfloat16", 40, 12, 9, 8, 2, "scalar"),
    ("float32", 1000, 16, 1000, 1, 0, "vec"), ("bfloat16", 1000, 64, 1000, 3, 0, "scalar"),
    ("float32", 30, 1040, 5, 2, 0, "scalar"), ("bfloat16", 30, 300, 5, 2, 1, "scalar"),
    ("float32", 40, 16, 9, 2, 0, "scalar"), ("bfloat16", 1000, 8, 1001, 1, 0, "vec"),
    ("float32", 30, 1040, 5, 1, 0, "vec"), ("bfloat16", 30, 2056, 5, 1, 0, "vec"),
]


def table_view(values: torch.Tensor, offset: int) -> torch.Tensor:
    """``values`` [V, D] copied into a contiguous view ``offset`` elements
    into its storage (a table pointer off 16-byte alignment for 1-3)."""
    base = torch.zeros(values.numel() + offset, dtype=values.dtype, device=values.device)
    table = base[offset:].view(values.shape)
    table.copy_(values)
    return table


def bag_case(table, idx, weights, mask, device, what, route):
    """One ``embedding_bag`` call on ``table`` (on ``device``) against its
    plain version: bit-equal for bags of at most one slot, else ``TOL``. On
    the card it must be one launch, on ``route``."""
    from repro_torch.kernels import embedding_bag, embedding_bag_plain

    on = [None if x is None else x.to(device) for x in (weights, mask)]
    before = embedding_bag.launches_vec, embedding_bag.launches_scalar
    got = embedding_bag(table, idx.to(device), *on).cpu()
    want = embedding_bag_plain(table.cpu(), idx, weights, mask)
    if idx.shape[1] <= 1:  # a copy of one row times its weight, or 0: exact
        if not torch.equal(got, want):
            raise AssertionError(f"embedding_bag {what}")
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[table.dtype],
                                   atol=TOL[table.dtype])
    if device.type != "cuda":
        return
    took = {"vec": embedding_bag.launches_vec - before[0],
            "scalar": embedding_bag.launches_scalar - before[1]}
    if took != {r: int(r == route) for r in took}:
        raise AssertionError(f"embedding_bag {what}: launches {took}, not one on {route}")


def check_embedding_bag(device, gen):
    """``embedding_bag`` over ``BAG_CASES`` (with weights, masks and ids
    −1, V and 2³¹−1) and ``BAG_SWEEP``, each case on the card on the route
    it names. Returns the cases, all and per route."""
    took = {"cases": 0, "vec": 0, "scalar": 0}
    # BAG_CASES: aligned tables of rows a multiple of 16 bytes, so one-slot
    # bags take vec
    shapes = [(dt, v, d, b, h, 0, "vec" if h == 1 else "scalar")
              for dt in ("float32", "bfloat16") for v, d, b, h in BAG_CASES] + BAG_SWEEP
    for dt, v_rows, d, b, h, off, route in shapes:
        dt = getattr(torch, dt)
        table = table_view(torch.randn((v_rows, d), generator=gen).to(dt).to(device), off)
        idx = torch.randint(0, v_rows, (b, h), generator=gen, dtype=torch.int32)
        idx.view(-1)[:3] = torch.tensor([-1, v_rows, 2**31 - 1])[: idx.numel()]
        w = torch.randn((b, h), generator=gen).to(dt)
        mask = torch.rand((b, h), generator=gen) < 0.8
        for weights, m in ((None, None), (w, None), (None, mask), (w, mask)):
            what = f"{dt} {(v_rows, d, b, h)} +{off} weights {weights is not None} " \
                   f"mask {m is not None}"
            bag_case(table, idx, weights, m, device, what, route)
            took["cases"] += 1
            if device.type == "cuda":
                took[route] += 1
    if device.type == "cuda" and not (took["vec"] and took["scalar"]):
        raise AssertionError(f"the embedding_bag sweep left a route untaken: {took}")
    return took


def check_model_kernels(device, gen):
    """``flash_attention`` and ``embedding_bag`` against their plain
    versions over their sweeps, at the f32 / bf16 ``TOL`` (flash also row
    by row, ``FLASH_ROW``). Returns the cases per kernel and route, and
    flash's largest row ratio per dtype."""
    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import route, tc_uses_tensor_cores

    route_cases = {"tc": 0, "simt": 0}
    cases = {"flash_attention": 0}
    row_ratio = {}
    if device.type == "cuda":  # the wrapper's route rule is the C entry's
        for dt in (torch.float32, torch.bfloat16):
            for d in range(1, 129):
                if tc_uses_tensor_cores(dt, d) != (route(dt, d) == "tc"):
                    raise AssertionError(f"route rules disagree at {dt}, D={d}")
    for dt in (torch.float32, torch.bfloat16):
        extra = FLASH_BF16_CASES if dt == torch.bfloat16 else []
        for b, h, hkv, sq, sk, d, causal, window in FLASH_CASES + extra:
            q = torch.randn((b, h, sq, d), generator=gen).to(dt).to(device)
            k = torch.randn((b, hkv, sk, d), generator=gen).to(dt).to(device)
            v = torch.randn((b, hkv, sk, d), generator=gen).to(dt).to(device)
            # scale 1 as the TPU kernel (f32 scores); the model's scale
            # with the scores rounded to the inputs' type, as the model runs
            for scale in (1.0, d**-0.5):
                rnd = scale != 1.0
                before = flash_attention.launches_tc, flash_attention.launches_simt
                got = flash_attention(q, k, v, causal, window, scale, round_scores=rnd)
                want = flash_attention_plain(q, k, v, causal, window, scale,
                                             round_scores=rnd)
                what = (f"{dt} {(b, h, hkv, sq, sk, d, causal, window)} scale {scale}"
                        f" round_scores {rnd}")
                if device.type == "cuda":
                    took = "tc" if flash_attention.launches_tc > before[0] else "simt"
                    if took != route(dt, d):
                        raise AssertionError(f"flash_attention {what} took {took}")
                    route_cases[took] += 1
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=TOL[dt], atol=TOL[dt])
                ratio = flash_row_check(got, want, what)
                row_ratio[str(dt)] = max(row_ratio.get(str(dt), 0.0), ratio)
                cases["flash_attention"] += 1
    # NaN in the rows that follow a kv head's last key (the next head's
    # first rows), which a flattened map would read into the tile past Sk:
    # the heads of kv head 0 must not see it
    q = torch.randn((1, 4, 100, 80), generator=gen).to(torch.bfloat16).to(device)
    k = torch.randn((1, 2, 100, 80), generator=gen).to(torch.bfloat16).to(device)
    v = torch.randn((1, 2, 100, 80), generator=gen).to(torch.bfloat16).to(device)
    v[0, 1, :28] = float("nan")
    got = flash_attention(q, k, v, True, None, 80**-0.5)[:, :2]
    want = flash_attention_plain(q[:, :2], k[:, :1], v[:, :1], True, None, 80**-0.5)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("flash_attention: NaN past Sk reached a head that keeps none")
    flash_row_check(got, want, "with NaN in the next kv head's rows")
    cases["flash_attention"] += 1
    cases.update({f"flash_attention_{r}": n for r, n in route_cases.items()})
    bag = check_embedding_bag(device, gen)
    cases["embedding_bag"] = bag.pop("cases")
    cases.update({f"embedding_bag_{r}": n for r, n in bag.items()})
    return cases, row_ratio


# -- 3. the main path and its oracles ------------------------------------------


def host_csr(graph):
    """(indptr, indices, data) of the out-edges (``t_*`` ordering) on the
    host, padding rows dropped (they sort last)."""
    n = graph.n_vertices
    ptr = graph.out_ptr.cpu().numpy().astype(np.int64)
    e = int(ptr[n])
    return ptr, graph.t_dst[:e].cpu().numpy(), graph.t_weight[:e].cpu().numpy()


def oracle_components(graph):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    ptr, idx, w = host_csr(graph)
    n = graph.n_vertices
    m = sp.csr_matrix((np.ones_like(w), idx, ptr), shape=(n, n))
    return connected_components(m, directed=False)[1]


def same_partition(labels, oracle) -> bool:
    a = np.unique(labels, return_inverse=True)[1].astype(np.int64)
    b = oracle.astype(np.int64)
    pairs = np.unique(a * (b.max() + 1) + b).size
    return pairs == np.unique(a).size == np.unique(b).size


def min_id_per_component(oracle):
    n = oracle.shape[0]
    out = np.full(oracle.max() + 1, n, np.int64)
    np.minimum.at(out, oracle, np.arange(n))
    return out[oracle]


def oracle_sssp(graph):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    # parallel edges stay as duplicate entries, which Dijkstra must treat
    # as alternatives: check that on a three-vertex graph first
    tiny = sp.csr_matrix(
        (np.array([5.0, 1.0, 1.0]), np.array([1, 1, 2]), np.array([0, 2, 3, 3])),
        shape=(3, 3),
    )
    if not np.array_equal(dijkstra(tiny, indices=0), [0.0, 1.0, 2.0]):
        raise AssertionError("scipy dijkstra does not take the cheaper parallel edge")
    ptr, idx, w = host_csr(graph)
    n = graph.n_vertices
    m = sp.csr_matrix((w.astype(np.float64), idx, ptr), shape=(n, n))
    return dijkstra(m, directed=True, indices=0)


def oracle_pagerank(graph, rounds: int = 30):
    """float64 power iteration of the PageRank program: dangling mass
    dropped, parallel edges counted with their multiplicity."""
    import scipy.sparse as sp

    ptr, idx, _ = host_csr(graph)
    n = graph.n_vertices
    deg = np.diff(ptr).astype(np.float64)
    src = np.repeat(np.arange(n), np.diff(ptr))
    a = sp.csr_matrix((np.ones(idx.shape[0]), (idx, src)), shape=(n, n))
    pr = np.full(n, 1.0 / n)
    for _ in range(rounds):
        share = np.divide(pr, deg, out=np.zeros(n), where=deg > 0)
        pr = 0.15 / n + 0.85 * (a @ share)
    return pr


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed_run(cp, graph, schedule, device):
    """One ``run_bsp`` of a compiled program, timed on the host clock up to
    the card's last kernel."""
    from repro_torch.pregel import run_bsp

    f0 = cp.init_fields()
    sync(device)
    t0 = time.perf_counter()
    res = run_bsp(cp.prog, graph, f0, schedule=schedule)
    sync(device)
    return res, time.perf_counter() - t0


def run_program(name, source, graph, schedule, device, card):
    """compile_program → run_bsp; checks the superstep count against the
    plan's cost model and reports wall time (the first run in this process,
    so it includes one-time loading of the library kernels it touches)."""
    from repro_torch.core import compile_program

    cp = compile_program(source, graph, schedule=schedule)
    res, wall = timed_run(cp, graph, schedule, device)
    key = {"pull": "palgol_pull", "push": "palgol_push"}[schedule]
    planned = cp.cost_models[key].count(res.trips)
    if res.supersteps != planned:
        raise AssertionError(f"{name}/{schedule}: {res.supersteps} supersteps, plan {planned}")
    say(
        "program", card, name=name, schedule=schedule, wall_s=wall,
        supersteps=res.supersteps, trips=res.trips,
        n_vertices=graph.n_vertices, n_edges=graph.n_edges,
    )
    return cp, res


def graph_shape(graph):
    """The degree statistics that shape the two graph kernels' work: the
    share of empty segments (in-degree 0), the mean and largest segment,
    segments past 4096 and 65536 rows and the share of rows they and the
    segments past 32 rows hold, and the share of neighbour reads (``src``
    in the dst ordering) that fall in the lowest 2^16, 2^18 and 2^20 ids."""
    n = graph.n_vertices
    deg = (graph.in_ptr[1:] - graph.in_ptr[:-1]).long()
    rows = int(deg.sum())
    src = graph.src[graph.edge_mask].long()
    return {
        "empty_share": float((deg == 0).sum()) / n,
        "mean_rows": rows / n,
        "max_rows": int(deg.max()),
        "max_rows_vertex": int(deg.argmax()),
        "segments_over_4096": int((deg > 4096).sum()),
        "segments_over_65536": int((deg > 65536).sum()),
        "row_share_over_4096": float(deg[deg > 4096].sum()) / rows,
        "row_share_over_32": float(deg[deg > 32].sum()) / rows,
        "read_share_below_2^16": float((src < 2**16).sum()) / rows,
        "read_share_below_2^18": float((src < 2**18).sum()) / rows,
        "read_share_below_2^20": float((src < 2**20).sum()) / rows,
    }


def graph_counters(zero: bool = False) -> dict:
    """The two graph kernels' launch counters (set to 0 first with
    ``zero``)."""
    from repro_torch.kernels import gather_rows, segment_reduce

    names = {
        gather_rows: ("launches", "launches_vec", "launches_scalar"),
        segment_reduce: ("launches", "launches_rows", "launches_cols"),
    }
    out = {}
    for fn, counters in names.items():
        for counter in counters:
            if zero:
                setattr(fn, counter, 0)
            key = fn.__name__ + ("" if counter == "launches" else counter[8:])
            out[key] = getattr(fn, counter)
    return out


def require_graph_routes(counts: dict, path: str):
    """Both graph kernels launched on ``path``, every launch on the
    redesigned routes (``vec`` / ``rows``)."""
    for name, route, other in (("gather_rows", "vec", "scalar"),
                               ("segment_reduce", "rows", "cols")):
        if counts[name] <= 0:
            raise AssertionError(f"the {path} path never launched {name}")
        if counts[f"{name}_{route}"] != counts[name]:
            raise AssertionError(f"{name}: {counts[f'{name}_{other}']} {path}-path "
                                 f"launches on the {other} route")


def main_path(scale, edgefactor, seed, device, card):
    """Build the graphs, then run the programs with the launch counters
    zeroed just before and read just after."""
    from repro_torch.core import algorithms as alg
    from repro_torch.graph import generators as G

    t0 = time.perf_counter()
    sym = G.rmat(scale, edgefactor, directed=False, seed=seed, device=device)
    dirw = G.rmat(scale, edgefactor, directed=True, weighted=True, seed=seed, device=device)
    sync(device)
    say(
        "graphs", card, setup_s=time.perf_counter() - t0, scale=scale,
        edgefactor=edgefactor, n_vertices=sym.n_vertices,
        symmetric_edges=sym.n_edges, directed_edges=dirw.n_edges,
        symmetric_shape=graph_shape(sym),
    )

    graph_counters(zero=True)
    runs = [
        ("sv", alg.SV, sym, "pull"),
        ("sv", alg.SV, sym, "push"),
        ("wcc", alg.WCC, sym, "pull"),
        ("sssp", alg.SSSP, dirw, "pull"),
        ("pagerank", alg.PAGERANK, dirw, "pull"),
    ]
    compiled = [run_program(*r, device, card) for r in runs]
    (_, sv_pull), (_, sv_push), (wcc_cp, wcc), (_, sssp), (_, pr) = compiled
    t0 = time.perf_counter()
    dense, dense_trips, dense_counts = wcc_cp.run()
    sync(device)
    say(
        "program", card, name="wcc", schedule="pull", entry="cp.run()",
        wall_s=time.perf_counter() - t0, supersteps=dense_counts["palgol_pull"],
        trips=dense_trips,
    )
    launches = graph_counters()
    say("launches", card, **launches)
    if device.type == "cuda":  # the plain versions launch nothing
        require_graph_routes(launches, "main")

    # steady state: every program once more, with every kernel loaded
    warm = []
    for (name, _, graph, schedule), (cp, first) in zip(runs, compiled):
        res, wall = timed_run(cp, graph, schedule, device)
        if res.supersteps != first.supersteps:
            raise AssertionError(f"{name}/{schedule}: a rerun took other supersteps")
        say(
            "program_warm", card, name=name, schedule=schedule, wall_s=wall,
            supersteps=res.supersteps, ms_per_superstep=wall * 1e3 / res.supersteps,
        )
        warm.append(wall)
    if dense_trips != wcc.trips or not torch.equal(dense["C"], wcc.fields["C"]):
        raise AssertionError("wcc: cp.run() and run_bsp disagree")
    if sv_pull.supersteps >= sv_push.supersteps:
        raise AssertionError("S-V: pull should take fewer supersteps than push")
    t0 = time.perf_counter()
    comp = oracle_components(sym)
    for label, res in (("sv/pull", sv_pull), ("sv/push", sv_push)):
        d = res.fields["D"].cpu().numpy()
        if not same_partition(d, comp):
            raise AssertionError(f"{label}: components differ from scipy")
    c = wcc.fields["C"].cpu().numpy()
    if not np.array_equal(c, min_id_per_component(comp)):
        raise AssertionError("wcc: labels are not the minimum id of each component")
    dist = oracle_sssp(dirw)
    got = sssp.fields["D"].cpu().numpy().astype(np.float64)
    if not np.array_equal(np.isinf(got), np.isinf(dist)):
        raise AssertionError("sssp: reachable sets differ from scipy dijkstra")
    fin = np.isfinite(dist)
    np.testing.assert_allclose(got[fin], dist[fin], rtol=1e-5, atol=0)
    ref = oracle_pagerank(dirw)
    np.testing.assert_allclose(
        pr.fields["PR"].cpu().numpy().astype(np.float64), ref, rtol=1e-4, atol=0
    )
    say(
        "oracles", card, ok=True, check_s=time.perf_counter() - t0,
        components=int(comp.max() + 1), sssp_reached=int(fin.sum()),
        pagerank_sum=float(ref.sum()),
    )
    replicated = [
        dict(name=name, source=source, graph=graph, schedule=schedule, cp=cp,
             result=res, warm_s=wall)
        for (name, source, graph, schedule), (cp, res), wall in zip(runs, compiled, warm)
    ]
    return launches, (sym, dirw), replicated


# -- 3b. the partitioned placement ------------------------------------------------

#: shards of the multi-rank run: gloo ranks on the one card
RANKS = 4
#: the programs of the S = 1 run (all five) and of the S = RANKS run
RANK_PROGRAMS = 4


def compare_run(label, res, want, tol_fields=()):
    """A partitioned run against the replicated one: supersteps, trips and
    frontiers equal, every field bit-equal except ``tol_fields`` (held to
    ``TOL``). Returns the largest difference of the ``tol_fields``."""
    if (res.supersteps, res.trips, res.active_sets) != (
        want.supersteps, want.trips, want.active_sets
    ):
        raise AssertionError(
            f"{label}: {res.supersteps} supersteps, trips {res.trips} against "
            f"{want.supersteps}, {want.trips} (or the frontiers differ)"
        )
    if set(res.fields) != set(want.fields):
        raise AssertionError(f"{label}: fields {sorted(res.fields)} != {sorted(want.fields)}")
    diff = {}
    for f, w in want.fields.items():
        got = res.fields[f]
        if got.dtype != w.dtype or got.shape != w.shape:
            raise AssertionError(f"{label}.{f}: {got.dtype}{tuple(got.shape)} != "
                                 f"{w.dtype}{tuple(w.shape)}")
        if f in tol_fields:
            tol = TOL[torch.float32]
            torch.testing.assert_close(got, w, rtol=tol, atol=tol, msg=f"{label}.{f}")
            diff[f] = {"max_abs_diff": float((got - w).abs().max()),
                       "bit_equal": bool(torch.equal(got, w))}
        elif not torch.equal(got, w):
            raise AssertionError(f"{label}.{f}: differs from the replicated run")
    return diff


def partition_rank(rank, port, device, shared, queue):
    """One gloo rank of the S = RANKS run, on ``device`` (every rank on
    the one card): runs each job through ``run_bsp(placement="partitioned")``
    over its shard of the partition (shared from the parent, on the card by
    CUDA IPC), holds rank 0's dense result against the replicated one, and
    reports walls and counters. ``shared`` is ``[pgs, jobs]``: emptied
    here, so that the process object keeps no reference and the blocks
    shared by CUDA IPC are released when this function returns."""
    import datetime
    import traceback

    import torch.distributed as dist

    pgs, jobs = shared
    shared.clear()
    try:
        from repro_torch.core import parse
        from repro_torch.dist import shard_mesh
        from repro_torch.pregel import run_bsp

        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=RANKS, timeout=datetime.timedelta(seconds=300),
        )
        mesh = shard_mesh(device=device)  # cuda:{rank % device_count}
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        graph_counters(zero=True)
        runs = []
        for job in jobs:
            sync(device)
            dist.barrier()
            t0 = time.perf_counter()
            res = run_bsp(parse(job["source"]), pgs[job["graph"]], job["fields"],
                          schedule=job["schedule"], placement="partitioned", mesh=mesh)
            sync(device)
            wall = time.perf_counter() - t0
            if rank == 0:
                compare_run(job["label"], res, job["want"])
            runs.append({"label": job["label"], "wall_s": wall,
                         "supersteps": res.supersteps})
            del res
        queue.put((rank, {"runs": runs, "launches": graph_counters()}))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def run_ranks(pgs, jobs, device):
    """Spawns RANKS gloo ranks on ``device`` and collects their reports;
    any rank's failure fails the phase, and every rank is stopped."""
    import queue as queue_mod
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=partition_rank, args=(r, port, device, [pgs, jobs], queue))
             for r in range(RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    reports = {}
    try:
        deadline = time.perf_counter() + 600
        while len(reports) < RANKS:
            try:
                rank, rep = queue.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise AssertionError(f"partitioned ranks: exit codes {dead} or timed out")
                continue
            if "error" in rep:
                raise AssertionError(f"partitioned rank {rank} failed:\n{rep['error']}")
            reports[rank] = rep
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * RANKS:
        raise AssertionError(f"partitioned ranks exited {codes}")
    return reports, time.perf_counter() - t0


def partitioned_path(graphs, replicated, device, card):
    """``run_bsp(placement="partitioned")`` on the main path's graphs: one
    shard in process (all five programs) and RANKS gloo ranks on the one
    card (the first four), each against its replicated run. Every run goes
    through both graph kernels; their counters are this phase's own."""
    from repro_torch.dist import shard_mesh
    from repro_torch.graph.partition import (
        partition_graph, partition_stats, request_dedup_report,
    )
    from repro_torch.pregel import run_bsp

    t_phase = time.perf_counter()
    sym, dirw = graphs
    keys = {id(sym): "sym", id(dirw): "dirw"}
    partition_s = {}

    def partition(n_shards):
        pgs = {}
        for key, g in (("sym", sym), ("dirw", dirw)):
            t0 = time.perf_counter()
            pg = partition_graph(g, n_shards)
            partition_s[f"{key}_s{n_shards}"] = time.perf_counter() - t0
            pgs[key] = pg
        return pgs

    # one shard, in this process
    pgs = {k: pg.to(device) for k, pg in partition(1).items()}
    mesh = shard_mesh(1, device=device)
    launches = graph_counters(zero=True)
    pr_diff = {}
    for run in replicated:
        key = keys[id(run["graph"])]
        f0 = run["cp"].init_fields()
        walls = []
        for _ in range(2):  # the first run, then a warm one
            sync(device)
            t0 = time.perf_counter()
            res = run_bsp(run["cp"].prog, pgs[key], f0, schedule=run["schedule"],
                          placement="partitioned", mesh=mesh)
            sync(device)
            walls.append(time.perf_counter() - t0)
        label = f"{run['name']}/{run['schedule']} S=1"
        diff = compare_run(label, res, run["result"],
                           tol_fields=("PR",) if run["name"] == "pagerank" else ())
        pr_diff.update(diff)
        say("partitioned_run", card, name=run["name"], schedule=run["schedule"],
            n_shards=1, wall_s=walls[0], warm_wall_s=walls[1],
            replicated_warm_wall_s=run["warm_s"], supersteps=res.supersteps,
            trips=res.trips, **({"pagerank_PR": diff["PR"]} if diff else {}))
        del res
    launches_s1 = graph_counters()
    if device.type == "cuda":
        wcc = replicated[2]
        device_busy(
            lambda: run_bsp(wcc["cp"].prog, pgs["sym"], wcc["cp"].init_fields(),
                            placement="partitioned", mesh=mesh),
            "wcc run_bsp partitioned S=1", card, program="wcc",
        )
    sv = replicated[0]
    first = run_bsp(sv["cp"].prog, sym, sv["cp"].init_fields(), max_iters=0)
    dedup = {
        "first_pull_round": request_dedup_report(first.fields["D"].cpu(), sym.n_vertices),
        "converged": request_dedup_report(sv["result"].fields["D"].cpu(), sym.n_vertices),
    }
    del pgs, first

    # RANKS gloo ranks on the one card, the partition shared by CUDA IPC
    host = partition(RANKS)
    stats = {k: partition_stats(pg) for k, pg in host.items()}
    pgs = {k: pg.to(device) for k, pg in host.items()}
    del host
    jobs = [
        dict(label=f"{run['name']}/{run['schedule']} S={RANKS}", source=run["source"],
             graph=keys[id(run["graph"])], schedule=run["schedule"],
             fields=run["cp"].init_fields(), want=run["result"])
        for run in replicated[:RANK_PROGRAMS]
    ]
    reports, ranks_s = run_ranks(pgs, jobs, device)
    for i, job in enumerate(jobs):
        say("partitioned_run", card, name=job["label"].split("/")[0],
            schedule=job["schedule"], n_shards=RANKS,
            transport="gloo, staged through the host",
            wall_s=max(reports[r]["runs"][i]["wall_s"] for r in range(RANKS)),
            replicated_warm_wall_s=replicated[i]["warm_s"],
            supersteps=reports[0]["runs"][i]["supersteps"])
    del pgs, jobs
    if device.type == "cuda":  # blocks shared by CUDA IPC wait here until collected
        torch.cuda.ipc_collect()
    for k in launches:
        launches[k] = launches_s1[k] + sum(rep["launches"][k] for rep in reports.values())
    say("partition", card, seconds=partition_s, ranks_s=ranks_s,
        **{f"stats_{k}_s{RANKS}": {
            key: v[key] for key in ("n_vertices", "n_edges", "v_max", "e_max",
                                    "shard_sizes", "halo_in_per_shard",
                                    "halo_out_per_shard", "halo_total",
                                    "halo_pair_cap")} for k, v in stats.items()},
        sv_request_dedup=dedup)
    say("launches", card, path="partitioned", **launches,
        in_process_s1=launches_s1,
        per_rank={r: rep["launches"] for r, rep in sorted(reports.items())})
    if device.type == "cuda":
        require_graph_routes(launches, "partitioned")
        for r, rep in sorted(reports.items()):
            require_graph_routes(rep["launches"], f"partitioned rank {r}")
    say("partitioned_phase", card, seconds=time.perf_counter() - t_phase,
        allocated_after_gb=torch.cuda.memory_allocated() / 1e9
        if device.type == "cuda" else None)
    return launches


# -- 3c. GNN serving ---------------------------------------------------------------

#: R-MAT average degrees that land each graph's symmetrised edge count
#: near its ``GNN_SHAPES`` target times ``GNN_EDGE_CUT`` (counted with the
#: generator's numpy draws at seed 0: ogb_products 61,886,476 of
#: 61,859,140 at scale 22; minibatch_lg 57,398,690 at scale 18, half of
#: Reddit's 114,615,892; full_graph_sm 10,552 of 10,556 at scale 12)
GNN_AVG_DEGREE = {"ogb_products": 7.58, "minibatch_lg": 150.0, "full_graph_sm": 1.38}
#: the share of a shape's edges its graph keeps: the host's R-MAT build of
#: the full Reddit edge count (degree 345 at scale 18) would take about
#: 100 s on the card's host, of the GNN phase's budget of about 150 s
GNN_EDGE_CUT = {"minibatch_lg": 0.5}
#: a forward through the kernels against the same forward through their
#: plain versions: max|Δ| over max|out|
GNN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
#: models whose random-weight forward outgrows any one scale (GraphCast's 16
#: residual bf16 layers reach max|out| ≈ 1e29): each element is held to
#: tol · |ref| + tol · median|ref| instead of tol · max|out|
GNN_ELEMENTWISE = ("graphcast",)
#: the full-graph models served on the ogb_products graph
GNN_FULL = ("graphsage-reddit", "gat-cora", "pna")
#: sampled GraphSAGE batches served on the Reddit-sized graph
MINIBATCHES = 8


@contextlib.contextmanager
def plain_graph_kernels():
    """The two graph kernels' wrappers pointed at their plain versions (the
    module attributes ``graph.ops`` calls), restored on the way out."""
    from repro_torch.kernels.gather_rows import ops as g
    from repro_torch.kernels.segment_reduce import ops as s

    saved = g.gather_rows, s.segment_reduce
    g.gather_rows, s.segment_reduce = g.gather_rows_plain, s.segment_reduce_plain
    try:
        yield
    finally:
        g.gather_rows, s.segment_reduce = saved


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_gb(device):
    return torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None


def edges_near(shape_id, e, target, share=0.05):
    """The graph's edge count within ``share`` of its shape's, after the
    shape's ``GNN_EDGE_CUT`` (no check for a ``None`` target)."""
    if target is None:
        return
    target = target * GNN_EDGE_CUT.get(shape_id, 1.0)
    if abs(e / target - 1) > share:
        raise AssertionError(f"{shape_id}: {e} edges, not within {share:.0%} of {target:.0f}")


def gnn_serve(arch, cfg, batch, seed, device, card):
    """``models.gnn.models.forward`` of ``cfg`` (weights from ``init(seed)``)
    on a full-graph batch: the first forward with the launch counters
    zeroed before and read after, three warm ones and one under the
    profiler (the card's busy share), then the same forward with the two
    graph kernels' wrappers pointed at their plain versions, held to
    ``GNN_TOL``. Returns the launches of one forward."""
    from repro_torch.models.gnn import models as gm

    n, e = batch["x"].shape[0], batch["src"].shape[0]
    params = gm.init(cfg, seed=seed, device=device)
    reset_peak(device)
    graph_counters(zero=True)
    sync(device)
    t0 = time.perf_counter()
    out = gm.forward(params, batch, cfg)
    sync(device)
    first_s = time.perf_counter() - t0
    launches = graph_counters()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        gm.forward(params, batch, cfg)
        sync(device)
        walls.append(time.perf_counter() - t0)
    warm_s = sorted(walls)[1]
    peak = peak_gb(device)
    if device.type == "cuda":
        device_busy(lambda: gm.forward(params, batch, cfg), f"gnn {arch} forward", card)
    if tuple(out.shape) != (n, cfg.n_out) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{arch}: output of shape {tuple(out.shape)} or not finite")
    reset_peak(device)
    with plain_graph_kernels():
        ref = gm.forward(params, batch, cfg)
    sync(device)
    plain_peak = peak_gb(device)
    diff, mag = (out - ref).abs(), ref.abs()
    err, scale = float(diff.max()), float(mag.max())
    tol = GNN_TOL[cfg.compute_dtype]
    if arch in GNN_ELEMENTWISE:
        check = f"|Δ| ≤ {tol}·|ref| + {tol}·median|ref| per element"
        limit = tol * mag + tol * float(mag.median())
    else:
        check = f"max|Δ| ≤ {tol}·max|out|"
        limit = tol * scale
    if not bool((diff <= limit).all()):
        raise AssertionError(f"{arch}: kernels against plain versions past {check}: "
                             f"max|Δ| {err}, max|out| {scale}")
    del diff, mag, limit
    agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    if device.type == "cuda" and not (launches["gather_rows_scalar"] > 0
                                      and launches["segment_reduce_cols"] > 0):
        raise AssertionError(f"{arch}: no launch on gather_rows scalar or segment_reduce "
                             f"cols: {launches}")
    say("gnn_serve", card, arch=arch, variant=cfg.variant, n_layers=cfg.n_layers,
        d_hidden=cfg.d_hidden, d_in=cfg.d_in, n_out=cfg.n_out,
        compute_dtype=cfg.compute_dtype, n_nodes=n, n_edges=e,
        first_ms=first_s * 1e3, warm_ms=warm_s * 1e3, warm_ms_runs=[w * 1e3 for w in walls],
        nodes_per_s=n / warm_s, edges_per_s=e / warm_s, peak_allocated_gb=peak,
        plain_check_peak_allocated_gb=plain_peak, launches=launches,
        versus_plain_max_abs_diff=err, max_abs_out=scale, check=check,
        argmax_agree_share=agree)
    del params, out, ref
    return launches


def numpy_sage_minibatch(params, batch, cfg):
    """float64 numpy forward of ``sage_minibatch_forward`` on one batch."""
    def np64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    f0, f1 = cfg.fanouts
    b = batch["seed_x"].shape[0]
    l1, l2 = [{k: np64(v) for k, v in lp.items()} for lp in params["layers"]]

    def masked_mean(vals, mask):
        w = mask[..., None].astype(np.float64)
        return (vals * w).sum(-2) / np.maximum(w.sum(-2), 1.0)

    def relu(x):
        return np.maximum(x, 0.0)

    hop0, hop1 = np64(batch["hop0_x"]), np64(batch["hop1_x"])
    m0, m1 = batch["hop0_mask"].cpu().numpy(), batch["hop1_mask"].cpu().numpy()
    h0 = relu(hop0 @ l1["w_self"] + masked_mean(hop1.reshape(b * f0, f1, -1), m1)
              @ l1["w_nbr"] + l1["b"])
    h_seed = relu(np64(batch["seed_x"]) @ l1["w_self"]
                  + masked_mean(hop0.reshape(b, f0, -1), m0) @ l1["w_nbr"] + l1["b"])
    h = relu(h_seed @ l2["w_self"] + masked_mean(h0.reshape(b, f0, -1), m0) @ l2["w_nbr"]
             + l2["b"])
    return h @ np64(params["head"])


def in_neighbour_check(graph, blocks):
    """Every masked sampled neighbour ``u`` of a node ``v`` is an in-edge
    ``u → v`` of the graph, and every unmasked one the sentinel: the pairs
    looked up on the host (``np.searchsorted``) in the graph's edge keys
    ``dst · n + src``, sorted once by ``torch.sort``. Returns the pairs."""
    n = graph.n_vertices
    keep = graph.edge_mask
    keys = torch.sort(graph.dst[keep].long() * n + graph.src[keep].long()).values.cpu().numpy()
    pairs = 0
    for blk in blocks:
        nodes = blk.nodes.cpu().numpy().astype(np.int64)
        nbrs = blk.neighbors.cpu().numpy().astype(np.int64)
        mask = blk.mask.cpu().numpy()
        if not (nbrs[~mask] == n).all():
            raise AssertionError("an unmasked sampled neighbour is not the sentinel")
        q = (np.broadcast_to(nodes[:, None], nbrs.shape) * n + nbrs)[mask]
        at = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
        if not (keys[at] == q).all():
            raise AssertionError(f"{int((keys[at] != q).sum())} sampled neighbours are "
                                 "not in-neighbours of their node")
        pairs += int(q.shape[0])
    return pairs


def minibatch_serve(cfg, graph, feats, labels, batch_nodes, n_batches, seed, device, card):
    """``gnn_minibatches`` → ``sage_minibatch_forward`` for ``n_batches``
    batches (the sampler's generator seeded with ``seed``), with the launch
    counters zeroed before and read after; then one batch replayed from the
    same seed to check its sampled neighbours on the host and its gathers,
    and its forward held to a float64 numpy forward (rtol 1e-5, atol
    1e-5 · max|logit|). Returns the launches and the replayed batch's
    hop-1 feature read, ``(features + sentinel row, flat neighbour ids)``."""
    from repro_torch.data import gnn_minibatches
    from repro_torch.graph.sampler import CSR, sample_khop
    from repro_torch.models.gnn import models as gm

    params = gm.init(cfg, seed=seed, device=device)
    reset_peak(device)
    graph_counters(zero=True)
    sync(device)
    sample_s, forward_s = [], []
    t0 = time.perf_counter()
    batches = gnn_minibatches(graph, feats, labels, batch_nodes, cfg.fanouts,
                              torch.Generator(device=device).manual_seed(seed))
    for i in range(n_batches):
        batch = next(batches)
        sync(device)
        t1 = time.perf_counter()
        sample_s.append(t1 - t0)
        out = gm.sage_minibatch_forward(params, batch, cfg)
        sync(device)
        t0 = time.perf_counter()
        forward_s.append(t0 - t1)
        if i == 0:
            first, first_out = batch, out
    launches = graph_counters()
    peak = peak_gb(device)
    if device.type == "cuda" and not launches["gather_rows_scalar"] > 0:
        raise AssertionError(f"the minibatch path never launched gather_rows scalar: {launches}")
    if tuple(first_out.shape) != (batch_nodes, cfg.n_out):
        raise AssertionError(f"minibatch logits of shape {tuple(first_out.shape)}")

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    seeds = torch.randint(0, graph.n_vertices, (batch_nodes,), generator=gen, device=device,
                          dtype=torch.int32)
    blocks = sample_khop(CSR.from_graph(graph), seeds, cfg.fanouts, gen)
    ext = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    for key, ids in (("seed_x", seeds), ("hop0_x", blocks[0].neighbors),
                     ("hop1_x", blocks[1].neighbors)):
        if not torch.equal(first[key], torch.index_select(ext, 0, ids.reshape(-1).long())):
            raise AssertionError(f"minibatch {key} is not the features at the replayed samples")
    pairs = in_neighbour_check(graph, blocks)
    want = numpy_sage_minibatch(params, first, cfg)
    np.testing.assert_allclose(first_out.cpu().numpy().astype(np.float64), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    masked = [float(b.mask.float().mean()) for b in blocks]
    say("gnn_serve", card, arch=cfg.name, mode="sampled minibatch", n_nodes=graph.n_vertices,
        n_edges=graph.n_edges, batch_nodes=batch_nodes, fanouts=list(cfg.fanouts),
        d_in=cfg.d_in, n_out=cfg.n_out, batches=n_batches,
        first_sample_ms=sample_s[0] * 1e3, warm_sample_ms=float(np.median(sample_s[1:])) * 1e3,
        first_forward_ms=forward_s[0] * 1e3,
        warm_forward_ms=float(np.median(forward_s[1:])) * 1e3,
        seeds_per_s=batch_nodes / float(np.median([a + b for a, b in
                                                   zip(sample_s[1:], forward_s[1:])])),
        peak_allocated_gb=peak, launches=launches, checked_pairs=pairs,
        mask_share_per_hop=masked, check_s=time.perf_counter() - t0,
        versus="float64 numpy forward, rtol 1e-5")
    return launches, (ext, blocks[1].neighbors.reshape(-1))


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def gnn_path(device, card, shapes=None, degrees=None, n_batches=MINIBATCHES, seed=0):
    """Serve the four GNNs at their published widths (``configs/``, weights
    from ``init(seed)``): graphsage-reddit, gat-cora and pna on one
    ogb_products-shaped batch (``gnn_full_batch``: R-MAT at scale 22, about
    62 M symmetric edges, d_feat 100, 47 classes), graphcast (16 layers ×
    512, bf16) on the full_graph_sm shape, and sampled graphsage-reddit
    minibatches on a Reddit-sized R-MAT (scale 18, d_in 602, fanouts 25-10,
    1,024 seeds a batch). ``shapes`` / ``degrees`` override
    ``GNN_SHAPES`` / ``GNN_AVG_DEGREE`` for a rehearsal at a small size
    (``n_edges`` None skips the edge-count check). Returns this phase's
    launches of both graph kernels and, on the card, their wide routes'
    times at these shapes (:func:`gnn_route_rows`)."""
    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPE_CLASSES, GNN_SHAPES
    from repro_torch.data import gnn_full_batch
    from repro_torch.graph import generators as G

    t_phase = time.perf_counter()
    shapes = shapes or GNN_SHAPES
    degrees = degrees or GNN_AVG_DEGREE
    build_s, total, per_model = {}, {}, {}

    def cfg_for(arch, shape_id):
        return configs.resolve_gnn_config(configs.get_spec(arch).config, shape_id,
                                          shapes[shape_id])

    # full-graph serving on the ogb_products shape
    ogb = shapes["ogb_products"]
    t0 = time.perf_counter()
    batch = gnn_full_batch(ogb["n_nodes"], degrees["ogb_products"], ogb["d_feat"],
                           GNN_SHAPE_CLASSES["ogb_products"], seed=seed, device=device)
    sync(device)
    build_s["ogb_products"] = time.perf_counter() - t0
    n, e = batch["x"].shape[0], batch["src"].shape[0]
    edges_near("ogb_products", e, ogb["n_edges"])
    deg = torch.diff(torch.searchsorted(batch["dst"], torch.arange(
        n + 1, dtype=torch.int32, device=device), out_int32=True))
    say("gnn_graph", card, shape="ogb_products", n_nodes=n, n_edges=e,
        target_nodes=ogb["n_nodes"], target_edges=ogb["n_edges"],
        avg_degree=degrees["ogb_products"], build_s=build_s["ogb_products"],
        max_in_degree=int(deg.max()), empty_share=float((deg == 0).float().mean()),
        segments_over_4096=int((deg > 4096).sum()))
    del deg
    for arch in GNN_FULL:
        per_model[arch] = gnn_serve(arch, cfg_for(arch, "ogb_products"), batch, seed,
                                    device, card)
        add_launches(total, per_model[arch])
    routes = gnn_route_rows(batch, per_model) if device.type == "cuda" else {}
    del batch

    # GraphCast at full width on the full_graph_sm shape
    sm = shapes["full_graph_sm"]
    cfg = cfg_for("graphcast", "full_graph_sm")
    t0 = time.perf_counter()
    batch = gnn_full_batch(sm["n_nodes"], degrees["full_graph_sm"], sm["d_feat"],
                           GNN_SHAPE_CLASSES["full_graph_sm"], seed=seed, task=cfg.task,
                           n_out=cfg.n_out, device=device)
    build_s["full_graph_sm"] = time.perf_counter() - t0
    edges_near("full_graph_sm", batch["src"].shape[0], sm["n_edges"])
    per_model["graphcast"] = gnn_serve("graphcast", cfg, batch, seed, device, card)
    add_launches(total, per_model["graphcast"])
    if device.type == "cuda":
        routes.update(gnn_route_rows(batch, per_model, graphcast=True))
    del batch

    # sampled GraphSAGE on a Reddit-sized graph
    minibatch = minibatch_graph(device, card, seed, shapes, degrees)
    cfg, graph, feats, labels, batch_nodes = minibatch
    per_model["graphsage-reddit minibatch"], hop1_read = minibatch_serve(
        cfg, graph, feats, labels, batch_nodes, n_batches, seed, device, card)
    add_launches(total, per_model["graphsage-reddit minibatch"])
    if device.type == "cuda":
        routes.update(gnn_route_rows(None, per_model, hop1_read=hop1_read))
    del graph, feats, labels, hop1_read
    say("launches", card, path="gnn", **total, per_model=per_model)
    say("gnn_phase", card, seconds=time.perf_counter() - t_phase, build_s=build_s)
    return total, routes, minibatch


def park(minibatch, device):
    """The minibatch phases' ``(cfg, graph, features, labels, seeds)`` with
    every tensor moved to ``device``: kept in host memory between the GNN
    phase and the training phase, so that the serving phases between them
    run beside none of its 2.1 GB (their peaks as before)."""
    cfg, graph, feats, labels, batch_nodes = minibatch
    moved = {f.name: getattr(graph, f.name).to(device) for f in dataclasses.fields(graph)
             if isinstance(getattr(graph, f.name), torch.Tensor)}
    return (cfg, dataclasses.replace(graph, **moved), feats.to(device), labels.to(device),
            batch_nodes)


def minibatch_graph(device, card, seed, shapes=None, degrees=None):
    """The sampled GraphSAGE phases' graph: a Reddit-sized R-MAT
    (``minibatch_lg``, its edges cut by ``GNN_EDGE_CUT``), f32 features
    [N, 602] and labels from ``seed``; ``(cfg, graph, features, labels,
    seeds a batch)``, built once for serving and training."""
    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.graph import generators as G

    shapes = shapes or GNN_SHAPES
    degrees = degrees or GNN_AVG_DEGREE
    mb = shapes["minibatch_lg"]
    cfg = configs.resolve_gnn_config(configs.get_spec("graphsage-reddit").config,
                                     "minibatch_lg", mb)
    scale = max(2, int(math.ceil(math.log2(mb["n_nodes"]))))
    t0 = time.perf_counter()
    graph = G.rmat(scale, degrees["minibatch_lg"], directed=False, seed=seed, device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    edges_near("minibatch_lg", graph.n_edges, mb["n_edges"])
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn((graph.n_vertices, mb["d_feat"]), generator=gen, device=device)
    labels = torch.randint(0, cfg.n_out, (graph.n_vertices,), generator=gen, device=device,
                           dtype=torch.int32)
    say("gnn_graph", card, shape="minibatch_lg", n_nodes=graph.n_vertices,
        n_edges=graph.n_edges, target_nodes=mb["n_nodes"], target_edges=mb["n_edges"],
        edge_cut=GNN_EDGE_CUT["minibatch_lg"], avg_degree=degrees["minibatch_lg"],
        scale=scale, build_s=build_s)
    return cfg, graph, feats, labels, mb["batch_nodes"]


def route_row(fn, nbytes, nops, launches, shape, plain=None, library=None, library_name=None,
              reps=10):
    """One wide-route time at a GNN shape: :func:`timed` against the bound
    of ``nbytes`` and ``nops``, and the plain version's and the library
    call's ms where given. Under 0.1 ms a call's time is mostly the host's
    (the wrapper's Python, the allocation and the launch), so there the
    kernel's and the library call's device time is added, each from a
    CUDA graph of the calls (:func:`graph_ms`)."""
    b_ms, by = bound(nbytes, nops)
    row = {**timed(fn, (b_ms, nbytes), reps), "bound_by": by, "launches_per_pass": launches,
           "plain_ms": None if plain is None else cuda_ms(plain, reps=3),
           "library_ms": None if library is None else cuda_ms(library, reps=3),
           "library": library_name, "shape": shape}
    if row["ms"] < 0.1:
        row["graph_ms"] = graph_ms(fn)
        row["library_graph_ms"] = None if library is None else graph_ms(library)
    return row


def graph_ms(fn, reps: int = 20) -> float:
    """The device's time for one call of ``fn``: ``reps`` calls captured in
    one CUDA graph (their launches on the capture stream, their allocations
    in its pool), replayed, by :func:`cuda_ms`. Only for small calls: the
    graph holds ``reps`` outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=5) / reps
    del graph
    return ms


def gnn_route_rows(batch, per_model, graphcast=False, hop1_read=None):
    """The two graph kernels' wide routes timed at the shapes of the GNN
    passes, each case first checked against its plain version: on the
    ogb_products batch ``gather_rows`` ``scalar`` of SAGE's ``x[src]``
    ([E, 100] f32, also the plain version), GAT's ``h[src]`` ([E, 8, 8]
    f32) and PNA's layer-0 ``x[src]`` ([E, 100] bf16), and
    ``segment_reduce`` ``cols`` of SAGE's mean sums ([E, 100] and [E, 128]
    f32, the first also plain and vertex 0's segment alone), GAT's
    softmax max ([E, 8] f32) and message sum ([E, 8, 8] f32), PNA's max
    and sum ([E, 75] bf16); with ``graphcast`` its [E, 512] bf16 gather and
    sum; with ``hop1_read`` = ``(table, idx)`` the minibatch's hop-1
    feature read ([B·25·10, 602] f32, at the sampled neighbours of a
    replayed batch). A gather's bound reads each *distinct* row its ids
    name once. Library calls: ``index_select`` for the gathers,
    ``index_add_`` for the sums and ``scatter_reduce`` ``amax`` for the max,
    in place into an ``[n + 1, ...]`` buffer made outside the timing, masked
    rows sent to its last row (no copy of the values)."""
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.kernels import (
        gather_rows, gather_rows_plain, segment_reduce, segment_reduce_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}

    def gather_row(name, table, idx, plain=False, launches=None):
        torch.cuda.empty_cache()
        got = gather_rows(table, idx)
        if not torch.equal(got, gather_rows_plain(table, idx)):
            raise AssertionError(f"gather_rows {name} disagrees with its plain version")
        del got
        row_bytes = table[0].numel() * table.element_size()
        distinct = torch.unique(idx.clamp(0, table.shape[0] - 1)).numel()
        nbytes = distinct * row_bytes + idx.numel() * 4 + idx.numel() * row_bytes
        rows[name] = {"kernel": "gather_rows", "kernel_route": "scalar", **route_row(
            lambda: gather_rows(table, idx), nbytes, 0, launches,
            f"table {str(table.dtype)[6:]}{list(table.shape)}, idx i32[{idx.numel()}]",
            plain=(lambda: gather_rows_plain(table, idx)) if plain else None,
            library=lambda: torch.index_select(table, 0, idx), library_name="index_select"),
            "distinct_rows": distinct}

    def segment_row(name, vals, ids, n, op, mask, off, plain=False, launches=None):
        torch.cuda.empty_cache()
        got = segment_reduce(vals, ids, n, op, mask=mask, offsets=off)
        want = segment_reduce_plain(vals, ids, n, op, mask=mask)
        if op == "sum":  # summation orders differ: TOL of the magnitude summed
            mag = segment_reduce(vals.abs(), ids, n, op, mask=mask, offsets=off).float()
            ok = bool(((got.float() - want.float()).abs() <= TOL[vals.dtype] * mag).all())
            del mag
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"segment_reduce {name} disagrees with its plain version")
        del got, want
        torch.cuda.empty_cache()
        rows_n = int(off[-1] - off[0])
        width = vals[0].numel()
        elem = vals.element_size()
        nbytes = rows_n * width * elem + rows_n + off.numel() * 4 + n * width * elem
        ids64 = ids.long()
        ishape = (-1,) + (1,) * (vals.ndim - 1)
        buf = torch.zeros((n + 1,) + vals.shape[1:], dtype=vals.dtype, device="cuda")
        if op == "sum":
            library = lambda: buf.index_add_(0, torch.where(mask, ids64, n), vals)  # noqa: E731
            lib_name = "index_add_"
        else:
            library = lambda: buf.scatter_reduce_(  # noqa: E731
                0, torch.where(mask, ids64, n).reshape(ishape).expand(vals.shape), vals, "amax",
                include_self=False)
            lib_name = "scatter_reduce_ amax"
        rows[name] = {"kernel": "segment_reduce", "kernel_route": "cols", "op": op, **route_row(
            lambda: segment_reduce(vals, ids, n, op, mask=mask, offsets=off), nbytes,
            rows_n * width, launches,
            f"values {str(vals.dtype)[6:]}{list(vals.shape)} {op}, mask, {n} segments",
            plain=(lambda: segment_reduce_plain(vals, ids, n, op, mask=mask)) if plain else None,
            library=library, library_name=lib_name)}
        del buf, ids64

    if hop1_read is not None:  # the minibatch's hop-1 feature read
        gather_row("minibatch_hop1_x", *hop1_read,
                   launches=per_model["graphsage-reddit minibatch"]["gather_rows_scalar"])
        return rows
    src, dst, mask = batch["src"], batch["dst"], batch["emask"]
    n = batch["x"].shape[0]
    off = segment_offsets(dst, n)
    if graphcast:
        x = torch.randn((n, 512), generator=gen, device="cuda").to(torch.bfloat16)
        gather_row("graphcast_x_src", x, src, launches=per_model["graphcast"]["gather_rows_scalar"])
        vals = gather_rows(x, src)
        segment_row("graphcast_sum", vals, dst, n, "sum", mask, off,
                    launches=per_model["graphcast"]["segment_reduce_cols"])
        return rows
    sage, gat, pna = (per_model[a] for a in GNN_FULL)
    x = batch["x"]
    gather_row("sage_x_src", x, src, plain=True, launches=sage["gather_rows_scalar"])
    vals = gather_rows(x, src)
    segment_row("sage_mean_sum", vals, dst, n, "sum", mask, off, plain=True,
                launches=sage["segment_reduce_cols"])
    hub = int(torch.argmax(torch.diff(off)))
    hub_off = off[hub:hub + 2].contiguous()
    hub_rows = int(hub_off[1] - hub_off[0])
    hub_bytes = hub_rows * (100 * 4 + 1) + 2 * 4 + 100 * 4  # values, mask, offsets, out
    rows["sage_mean_sum_hub_only"] = {
        "kernel": "segment_reduce", "kernel_route": "cols", "vertex": hub, "rows": hub_rows,
        **route_row(lambda: segment_reduce(vals, dst, 1, "sum", mask=mask, offsets=hub_off),
                    hub_bytes, hub_rows * 100, None,
                    f"vertex {hub}'s segment alone, values f32[{hub_rows}, 100]", reps=3)}
    del vals
    vals = torch.randn((src.numel(), 128), generator=gen, device="cuda")
    segment_row("sage_layer2_sum", vals, dst, n, "sum", mask, off,
                launches=sage["segment_reduce_cols"])
    del vals
    h = torch.randn((n, 8, 8), generator=gen, device="cuda")
    gather_row("gat_h_src", h, src, launches=gat["gather_rows_scalar"])
    scores = gather_rows(h[:, :, 0].contiguous(), src)
    segment_row("gat_softmax_max", scores, dst, n, "max", mask, off,
                launches=gat["segment_reduce_cols"])
    del scores
    vals = gather_rows(h, src)
    segment_row("gat_message_sum", vals, dst, n, "sum", mask, off,
                launches=gat["segment_reduce_cols"])
    del vals, h
    xb = x.to(torch.bfloat16)
    gather_row("pna_x_src", xb, src, launches=pna["gather_rows_scalar"])
    vals = gather_rows(xb[:, :75].contiguous(), src)
    segment_row("pna_max", vals, dst, n, "max", mask, off, launches=pna["segment_reduce_cols"])
    segment_row("pna_sum", vals, dst, n, "sum", mask, off, launches=pna["segment_reduce_cols"])
    del vals, xb
    return rows


# -- 4. kernel times ------------------------------------------------------------


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, nops: int, ops_per_s: float = SCALAR_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn, want_ms_bound, reps: int = 20):
    """``{"ms", "bound_share", "gb_s"}`` of ``fn`` against a bound of
    ``(bound_ms, bytes)``."""
    bound_ms, nbytes = want_ms_bound
    ms = cuda_ms(fn, reps)
    return {"ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
            "gb_s": nbytes / ms / 1e6}


def graph_kernel_shapes(sym, table):
    """The two graph kernels over the shapes that tell their limits apart,
    through the public wrappers only (so that it times any tree of the port):
    ``gather_rows`` of ``table`` (int32 [n]) at the symmetric graph's edge
    count over four index patterns — the streaming floor (arange), the
    index and output streams alone (random over 2^14 rows, a table that
    stays in L1), L2-resident random reads (random over all n rows) and the
    graph's ``src`` — and of a bool table at ``src`` (SSSP's active flag),
    each beside ``index_select``; ``segment_reduce`` min over WCC's
    neighbour values at the graph's offsets, over vertex 0's segment alone
    (the hub) and over a uniform degree of 30 on the same vertices (no
    skew), each beside ``scatter_reduce``."""
    from repro_torch.kernels import (
        gather_rows, gather_rows_plain, segment_reduce, segment_reduce_plain,
    )

    n, e = table.numel(), sym.src.numel()
    gen = torch.Generator(device="cuda").manual_seed(0)
    g_bytes = n * 4 + e * 4 + e * 4
    gather = {}
    for name, make in (
        ("arange", lambda: (torch.arange(e, device="cuda") % n).to(torch.int32)),
        ("random_2^14", lambda: torch.randint(0, 2**14, (e,), device="cuda", generator=gen,
                                              dtype=torch.int32)),
        ("random_2^22", lambda: torch.randint(0, n, (e,), device="cuda", generator=gen,
                                              dtype=torch.int32)),
        ("sym.src", lambda: sym.src),
    ):
        idx = make()
        if not torch.equal(gather_rows(table, idx), torch.index_select(table, 0, idx)):
            raise AssertionError(f"gather_rows disagrees with index_select over {name}")
        gather[name] = {
            **timed(lambda: gather_rows(table, idx), (bound(g_bytes, 0)[0], g_bytes)),
            "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx)),
        }
        del idx
    flags = table < n // 2
    if not torch.equal(gather_rows(flags, sym.src), gather_rows_plain(flags, sym.src)):
        raise AssertionError("gather_rows disagrees with its plain version on a bool table")
    b_bytes = n + e * 4 + e
    gather["sym.src_bool"] = {
        **timed(lambda: gather_rows(flags, sym.src), (bound(b_bytes, 0)[0], b_bytes)),
        "library_ms": cuda_ms(lambda: torch.index_select(flags, 0, sym.src)),
    }
    del flags

    vals = gather_rows(table, sym.src)
    mask = sym.edge_mask
    identity = torch.full((n,), torch.iinfo(torch.int32).max, dtype=torch.int32, device="cuda")
    seg = {}
    hub_off = sym.in_ptr[:2].contiguous()
    hub_rows = int(hub_off[1] - hub_off[0])
    uni_ids = torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device="cuda"), 30)
    uni_ids = torch.cat([uni_ids, torch.full((e - uni_ids.numel(),), n, dtype=torch.int32,
                                             device="cuda")])
    for name, ids, off, nseg, rows in (
        ("wcc_min", sym.dst, sym.in_ptr, n, e),
        ("hub_only", sym.dst, hub_off, 1, hub_rows),
        ("uniform_degree_30", uni_ids, torch.arange(n + 1, dtype=torch.int32, device="cuda") * 30,
         n, 30 * n),
    ):
        got = segment_reduce(vals, ids, nseg, "min", mask=mask, offsets=off)
        if name != "hub_only" and not torch.equal(
                got, segment_reduce_plain(vals, ids, nseg, "min", mask=mask)):
            raise AssertionError(f"segment_reduce disagrees with its plain version: {name}")
        nbytes = rows * 5 + (nseg + 1) * 4 + nseg * 4
        ids64 = ids.long().clamp(max=n - 1)
        seg[name] = {
            **timed(lambda: segment_reduce(vals, ids, nseg, "min", mask=mask, offsets=off),
                    (bound(nbytes, rows)[0], nbytes)),
            "rows": rows,
            "library_ms": None if name == "hub_only" else cuda_ms(
                lambda: identity.scatter_reduce(0, ids64, torch.where(mask, vals, identity[0]),
                                                "amin", include_self=True), reps=3),
        }
        del ids64
    return {"gather_rows": gather, "segment_reduce": seg}


def kernel_rows(graphs, launches, partitioned):
    """Each kernel at the main path's shapes: its time, the plain version's,
    the library call's, its bound and its error against the plain version;
    gather_rows also over four index patterns, segment_reduce also over
    vertex 0's segment alone, a uniform degree and PageRank's f32 sum.
    ``launches`` are the graph main path's counts, ``partitioned`` the
    partitioned phase's (``launches_partitioned``)."""
    from repro_torch.graph import ops as gops
    from repro_torch.kernels import (
        gather_rows, gather_rows_plain, segment_reduce, segment_reduce_plain,
    )

    sym, dirw = graphs
    n = sym.n_vertices
    # gather: WCC's neighbour read C[e.id] — an int32 field at every edge
    table = torch.randperm(n, device="cuda").to(torch.int32)
    shapes = graph_kernel_shapes(sym, table)
    idx = sym.src
    got = gather_rows(table, idx)
    if not torch.equal(got, gather_rows_plain(table, idx)):
        raise AssertionError("gather_rows disagrees with its plain version")
    err_g = (got - gather_rows_plain(table, idx)).abs().max().item()
    e = idx.numel()
    g_bytes = table.numel() * 4 + e * 4 + got.numel() * 4
    g_bound, g_by = bound(g_bytes, 0)
    g = timed(lambda: gather_rows(table, idx), (g_bound, g_bytes))
    rows = [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "src/repro_torch/csrc/gather_rows.cu",
        "replaces": "src/repro/kernels/gather_rows/kernel.py:20",
        "launches": launches["gather_rows"],
        "launches_partitioned": partitioned["gather_rows"],
        "max_abs_err": float(err_g),
        "ms": g["ms"],
        "plain_ms": cuda_ms(lambda: gather_rows_plain(table, idx)),
        "bound_ms": g_bound,
        "bound_by": g_by,
        "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx)),
        "shape": f"table i32[{n}], idx i32[{e}]",
        "kernel_route": "vec",
        "bound_share": g["bound_share"],
        "gb_s": g["gb_s"],
        "index_patterns": shapes["gather_rows"],
    }]

    # segment reduce: WCC's minimum [C[e.id] | e <- Nbr[v]] over the
    # symmetric graph, and PageRank's float sum over In[v] of the directed one
    vals = gops.gather(table, sym.src)
    mask = sym.edge_mask
    got = segment_reduce(vals, sym.dst, n, "min", mask=mask, offsets=sym.in_ptr)
    want = segment_reduce_plain(vals, sym.dst, n, "min", mask=mask)
    if not torch.equal(got, want):
        raise AssertionError("segment_reduce disagrees with its plain version")
    err = (got.long() - want.long()).abs().max().item()
    # values k/16 in [0, 1): every partial sum below 2**20 is exact in f32,
    # so the sum cannot depend on the order and the check is exact; a
    # dropped edge or a zeroed segment changes it by at least 1/16
    fvals = torch.randint(0, 16, (dirw.n_edges,), device="cuda").float() / 16
    fgot = segment_reduce(fvals, dirw.dst, n, "sum", mask=dirw.edge_mask, offsets=dirw.in_ptr)
    fwant = segment_reduce_plain(fvals, dirw.dst, n, "sum", mask=dirw.edge_mask)
    if fwant.max().item() >= 2**20:
        raise AssertionError("a segment sum reaches 2**20: f32 sums are no longer exact")
    torch.testing.assert_close(fgot, fwant, rtol=0, atol=0)
    err = max(err, (fgot - fwant).abs().max().item())
    s_bytes = e * 4 + e + (n + 1) * 4 + n * 4
    s_bound, s_by = bound(s_bytes, e)
    s = timed(lambda: segment_reduce(vals, sym.dst, n, "min", mask=mask, offsets=sym.in_ptr),
              (s_bound, s_bytes))
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids64 = sym.dst.long()
    ident = torch.full((n,), torch.iinfo(torch.int32).max, dtype=torch.int32, device="cuda")
    # PageRank's sum over In[v]: random f32 shares, at TOL, bit for bit
    # from one launch to the next
    pr = torch.rand(dirw.n_edges, device="cuda", generator=gen)
    pgot = segment_reduce(pr, dirw.dst, n, "sum", mask=dirw.edge_mask, offsets=dirw.in_ptr)
    pwant = segment_reduce_plain(pr, dirw.dst, n, "sum", mask=dirw.edge_mask)
    torch.testing.assert_close(pgot, pwant, rtol=TOL[torch.float32], atol=TOL[torch.float32])
    again = segment_reduce(pr, dirw.dst, n, "sum", mask=dirw.edge_mask, offsets=dirw.in_ptr)
    if not torch.equal(pgot.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("segment_reduce: PageRank's f32 sum changed bits between launches")
    pe = dirw.n_edges
    p_bytes = pe * 4 + pe + (n + 1) * 4 + n * 4
    p_bound, _ = bound(p_bytes, pe)
    p_ids64 = dirw.dst.long().clamp(max=n - 1)
    p_mask = dirw.edge_mask
    zeros = torch.zeros(n, device="cuda")
    pagerank = {
        **timed(lambda: segment_reduce(pr, dirw.dst, n, "sum", mask=p_mask,
                                       offsets=dirw.in_ptr), (p_bound, p_bytes)),
        "plain_ms": cuda_ms(lambda: segment_reduce_plain(pr, dirw.dst, n, "sum", mask=p_mask),
                            reps=3),
        "library_ms": cuda_ms(lambda: zeros.scatter_reduce(
            0, p_ids64, torch.where(p_mask, pr, 0.0), "sum", include_self=True), reps=3),
        "shape": f"values f32[{pe}] sum, mask, {n} segments",
        "max_abs_err": float((pgot - pwant).abs().max()),
        "repeat_bitwise": True,
    }
    rows.append({
        "name": "segment_reduce",
        "route": "cuda",
        "source": "src/repro_torch/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce/kernel.py:55",
        "launches": launches["segment_reduce"],
        "launches_partitioned": partitioned["segment_reduce"],
        "max_abs_err": float(err),
        "ms": s["ms"],
        "plain_ms": cuda_ms(lambda: segment_reduce_plain(vals, sym.dst, n, "min", mask=mask)),
        "bound_ms": s_bound,
        "bound_by": s_by,
        "library_ms": cuda_ms(
            lambda: ident.scatter_reduce(0, ids64, vals, "amin", include_self=True)
        ),
        "shape": f"values i32[{e}] min, mask, {n} segments",
        "kernel_route": "rows",
        "bound_share": s["bound_share"],
        "gb_s": s["gb_s"],
        "hub_only": shapes["segment_reduce"]["hub_only"],
        "uniform_degree_30": shapes["segment_reduce"]["uniform_degree_30"],
        "pagerank_f32_sum": pagerank,
    })
    return rows


def device_busy(fn, what: str, card: str, **fields):
    """Device busy share of ``fn()`` under torch.profiler: the union of the
    card's activity intervals over the host wall time to its last kernel.
    Prints one ``device_busy`` line and returns ``fn``'s result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in device_events)
    by_name = {}
    for ev in device_events:
        by_name[ev.name[:60]] = by_name.get(ev.name[:60], 0.0) + ev.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    share = busy / wall_us if spans else None
    say(
        "device_busy", card, what=what, **fields,
        wall_ms_profiled=wall_us / 1e3, device_busy_ms=busy / 1e3,
        busy_share=share, idle_share=None if share is None else 1 - share,
        device_events=len(spans),
        top_device_ms=[[name, us / 1e3] for name, us in top],
    )
    return out


def busy_share(graph, supersteps: int, card):
    """Device busy share over one WCC run of ``supersteps`` supersteps."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import compile_program
    from repro_torch.pregel import run_bsp

    cp = compile_program(alg.WCC, graph)
    f0 = cp.init_fields()
    res = device_busy(lambda: run_bsp(cp.prog, graph, f0), "wcc run_bsp", card,
                      program="wcc", supersteps=supersteps)
    if res.supersteps != supersteps:
        raise AssertionError(f"wcc: the profiled run took {res.supersteps} supersteps")


# -- 4. LM serving: h2o-danube-1.8b --------------------------------------------


def lm_path(cfg, batch, prompt_len, steps, seed, device, card):
    """Serve ``batch`` random prompts through ``repro_torch.launch.serve``,
    check the flash kernel on one layer's real q/k/v and every decode step
    against a teacher-forced prefill. Returns what the kernel row needs."""
    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.launch import serve as srv
    from repro_torch.models import common
    from repro_torch.models.transformer import model as tm

    sync(device)
    t0 = time.perf_counter()
    params = tm.init(cfg, seed=seed, device=device)
    prompts = srv.random_prompts(cfg, batch, prompt_len, seed + 1, device)
    sync(device)
    init_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    flash_attention.launches_tc = 0
    flash_attention.launches_simt = 0
    res = srv.serve(params, cfg, prompts, steps)
    launches = flash_attention.launches
    launches_tc = flash_attention.launches_tc
    if device.type == "cuda" and not launches == launches_tc == cfg.n_layers:
        raise AssertionError(f"{launches} flash launches ({launches_tc} on the tensor "
                             f"cores) for one prefill of {cfg.n_layers} layers")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None
    warm = srv.serve(params, cfg, prompts, steps)  # every kernel loaded
    if not torch.equal(warm.tokens, res.tokens):
        raise AssertionError("a second greedy run gave other tokens")
    n_prompt, n_dec = batch * prompt_len, batch * steps
    say(
        "lm_serve", card, arch=cfg.name, batch=batch, prompt_len=prompt_len,
        decode_steps=steps, cache_capacity=res.capacity, params_init_s=init_s,
        n_params=cfg.n_params(), flash_launches=launches, flash_launches_tc=launches_tc,
        prefill_s=[res.prefill_s, warm.prefill_s],
        prefill_tok_s=[n_prompt / res.prefill_s, n_prompt / warm.prefill_s],
        decode_s=[res.decode_s, warm.decode_s],
        decode_tok_s=[n_dec / res.decode_s, n_dec / warm.decode_s],
        peak_allocated_gb=peak_gb, first_stream=res.tokens[0, :12].tolist(),
    )

    if device.type == "cuda":  # where a prefill's and a decode step's time goes
        _, cache = device_busy(
            lambda: tm.prefill(params, prompts, cfg, capacity=res.capacity,
                               full_logits=False), "lm prefill", card)
        device_busy(lambda: tm.decode_step_(params, cache, res.tokens[:, :1], cfg),
                    "lm decode step", card)
        del cache

    # (a) one layer's real q/k/v through the kernel and its plain version
    lp = params.layer(0)
    x = params.embed[prompts.long()].to(cfg.cdtype)
    pos = torch.arange(prompt_len, dtype=torch.int32, device=device)
    q, k, v = tm.project_qkv(lp, common.rms_norm(x, lp["ln1"]), pos, cfg)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    scale = cfg.head_dim**-0.5
    got = flash_attention(q, k, v, True, cfg.swa_window, scale, round_scores=True)
    want = flash_attention_plain(q, k, v, True, cfg.swa_window, scale, round_scores=True)
    tol = TOL[cfg.cdtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    err = (got.float() - want.float()).abs().max().item()
    row_ratio = flash_row_check(got, want, "at the prefill's layer 0")
    # the row check must see one 64-key cut at the window's edge: the plain
    # version with the window cut by 64 keys has to fail it
    cut = flash_attention_plain(q, k, v, True, cfg.swa_window - 64, scale,
                                round_scores=True)
    cut_worst, cut_ratio = flash_rows(cut, want)
    if not cut_worst > 1.0:
        raise AssertionError("the flash row check passes a window cut by 64 keys")
    del got, want, cut

    # (b) teacher-forced: each step's logits against one prefill over the
    # prompt and the tokens fed to the decode steps
    fed = torch.cat([prompts, res.tokens[:, :steps]], dim=1)
    ref = tm.prefill(params, fed, cfg, full_logits=True)[0]
    ref = ref[:, prompt_len - 1:].float()  # [B, steps + 1, V]
    got_l = torch.stack([lg.float() for lg in res.logits], dim=1)
    scale_l = ref.abs().max().item()
    atol = tol * scale_l
    diff = (got_l - ref).abs()
    if not diff.max().item() <= atol:
        raise AssertionError(f"decode logits differ from the teacher-forced prefill by "
                             f"{diff.max().item()} > {atol}")
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > atol
    agree = ref.argmax(-1).to(torch.int32) == res.tokens
    if not bool(agree[decided].all()):
        raise AssertionError("a greedy token differs where the reference's margin is decided")
    say(
        "lm_checks", card, ok=True, flash_max_abs_err=err, flash_tol=tol,
        flash_max_row_ratio=row_ratio, flash_row_limit=list(FLASH_ROW[cfg.cdtype]),
        window_cut_64_row_ratio=cut_ratio, window_cut_64_worst_over_limit=cut_worst,
        logits_max_abs_diff=diff.max().item(), logits_tol=atol,
        logits_max_abs=scale_l, positions=int(decided.numel()),
        greedy_checked=int(decided.sum().item()),
        greedy_agree_all=int(agree.sum().item()),
    )
    del ref, got_l, diff, params
    return {"launches": launches_tc, "q": q, "k": k, "v": v, "window": cfg.swa_window,
            "scale": scale, "max_abs_err": err}


# -- 4b. MoE serving: deepseek-moe-16b ------------------------------------------

#: prefill tokens held to the float64 oracle in check (b)
MOE_ORACLE_TOKENS = 256


def moe_counters(zero: bool = False) -> dict:
    """The MoE path's launch counters (``flash_attention`` and the two graph
    kernels, per route) and ``moe_ffn``'s routed and dropped slots, all set
    to 0 first with ``zero``."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models.transformer import moe

    out = graph_counters(zero)
    for counter in ("launches", "launches_tc", "launches_simt"):
        if zero:
            setattr(flash_attention, counter, 0)
        out["flash_attention" + counter[8:]] = getattr(flash_attention, counter)
    if zero:
        moe.moe_ffn.slots, moe.moe_ffn.dropped = 0, 0
    out["moe_slots"] = moe.moe_ffn.slots
    out["moe_dropped"] = int(moe.moe_ffn.dropped)
    return out


def require_moe_launches(counts: dict, what: str, n_layers: int, prefills: int, steps: int):
    """Exactly ``n_layers`` flash launches a prefill, all on the tensor
    cores, and ``2·n_layers`` ``gather_rows`` ``scalar`` and ``n_layers``
    ``segment_reduce`` ``cols`` launches a prefill and a decode step; none
    on ``vec``, ``rows`` or the SIMT flash route."""
    passes = prefills + steps
    want = {
        "flash_attention": n_layers * prefills, "flash_attention_tc": n_layers * prefills,
        "flash_attention_simt": 0,
        "gather_rows": 2 * n_layers * passes, "gather_rows_scalar": 2 * n_layers * passes,
        "gather_rows_vec": 0,
        "segment_reduce": n_layers * passes, "segment_reduce_cols": n_layers * passes,
        "segment_reduce_rows": 0,
    }
    got = {name: counts[name] for name in want}
    if got != want:
        raise AssertionError(f"moe {what}: launches {got}, want {want}")


@contextlib.contextmanager
def moe_routes(log: list, pins=None):
    """``moe.route`` wrapped, restored on the way out. Without ``pins``
    each call appends its expert ids to ``log``. With ``pins``, call ``i``
    routes to the ids ``pins[i]`` in place of its own, each gate its own
    probability at that id, normalised over the k as ``route`` does, and
    appends to ``log`` the tokens whose own top-k set differs from the
    pinned one and each token's own log-probability gap between its k-th
    and (k+1)-th expert."""
    from repro_torch.models.transformer import moe

    route, calls = moe.route, iter(pins or ())

    def wrapped(x, router_w, mcfg):
        idx, gate, aux = route(x, router_w, mcfg)
        if pins is None:
            log.append(idx)
            return idx, gate, aux
        pin = next(calls)
        probs = torch.softmax(x.float() @ router_w, dim=-1)
        top = probs.topk(mcfg.top_k + 1, dim=-1).values.log()
        log.append(((idx.sort(1).values != pin.sort(1).values).any(1),
                    top[:, -2] - top[:, -1]))
        pg = probs.gather(1, pin.long())
        return pin, pg / pg.sum(dim=-1, keepdim=True).clamp_min(1e-9), aux

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = route


def moe_path(cfg, batch, prompt_len, steps, seed, device, card):
    """Serve ``cfg`` (deepseek-moe-16b: 28 layers, d 2048, 64 routed experts
    top-6 and 2 shared, random weights from ``seed``) through
    ``repro_torch.launch.serve``: a prefill of ``batch`` random prompts and
    ``steps`` greedy decode steps, twice (the same tokens), with the launches
    of one serve, one prefill and one decode step asserted exactly. Checks:
    (a) layer 0's real q/k/v through ``flash_attention`` against its plain
    version row by row, and the smallest window cut (from 64 keys, doubling)
    that the row check catches; (b) layer 0's MoE FFN on its real ``ln2``
    input against the same ``moe_ffn`` on the plain versions, against a
    float64 oracle over ``MOE_ORACLE_TOKENS`` tokens, and its keep mask on
    the host; (c) a second serve with ``capacity_factor = E / k`` (no slot
    dropped) against one teacher-forced prefill over the prompts and the
    fed tokens, the prefill's routing pinned to the serve's (see
    :func:`moe_teacher_forced`), on the served flash path. Returns the kernel
    rows at this path's shapes on the card, else ``[]``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.launch import serve as srv
    from repro_torch.models import common
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer import moe

    t_phase = time.perf_counter()
    mcfg = cfg.moe
    n_layers, e, k = cfg.n_layers, mcfg.n_experts, mcfg.top_k
    reset_peak(device)
    sync(device)
    t0 = time.perf_counter()
    params = tm.init(cfg, seed=seed, device=device)
    prompts = srv.random_prompts(cfg, batch, prompt_len, seed + 1, device)
    sync(device)
    init_s = time.perf_counter() - t0
    init_peak = peak_gb(device)
    reset_peak(device)

    moe_counters(zero=True)
    res = srv.serve(params, cfg, prompts, steps)
    serve_counts = moe_counters()
    peak = peak_gb(device)
    warm = srv.serve(params, cfg, prompts, steps)  # every kernel loaded
    if not torch.equal(warm.tokens, res.tokens):
        raise AssertionError("moe: a second greedy run gave other tokens")

    # one prefill and one decode step alone: their launches, the prefill's
    # drops, and on the card where their time goes
    def profiled(fn, what):
        return device_busy(fn, what, card) if device.type == "cuda" else fn()

    moe_counters(zero=True)
    _, cache = profiled(lambda: tm.prefill(params, prompts, cfg, capacity=res.capacity,
                                           full_logits=False), "moe prefill")
    prefill_counts = moe_counters()
    moe_counters(zero=True)
    profiled(lambda: tm.decode_step_(params, cache, res.tokens[:, :1], cfg), "moe decode step")
    step_counts = moe_counters()
    del cache
    if device.type == "cuda":
        require_moe_launches(serve_counts, "serve", n_layers, 1, steps)
        require_moe_launches(prefill_counts, "prefill", n_layers, 1, 0)
        require_moe_launches(step_counts, "decode step", n_layers, 0, 1)
    if step_counts["moe_dropped"] != 0:
        raise AssertionError(f"moe: a decode step of {batch} tokens dropped "
                             f"{step_counts['moe_dropped']} slots")
    n_prompt, n_dec = batch * prompt_len, batch * steps
    say(
        "moe_serve", card, arch=cfg.name, n_layers=n_layers, d_model=cfg.d_model,
        n_experts=e, top_k=k, n_shared_experts=mcfg.n_shared_experts,
        n_params=cfg.n_params(), n_active_params=cfg.n_active_params(), batch=batch,
        prompt_len=prompt_len, decode_steps=steps, cache_capacity=res.capacity,
        expert_capacity_prefill=moe.capacity(n_prompt, mcfg),
        expert_capacity_decode=moe.capacity(batch, mcfg), params_init_s=init_s,
        init_peak_allocated_gb=init_peak,
        prefill_s=[res.prefill_s, warm.prefill_s],
        prefill_tok_s=[n_prompt / res.prefill_s, n_prompt / warm.prefill_s],
        decode_s=[res.decode_s, warm.decode_s],
        decode_tok_s=[n_dec / res.decode_s, n_dec / warm.decode_s],
        peak_allocated_gb=peak, prefill_slots=prefill_counts["moe_slots"],
        prefill_dropped=prefill_counts["moe_dropped"],
        prefill_dropped_share=prefill_counts["moe_dropped"] / prefill_counts["moe_slots"],
        launches_serve=serve_counts, launches_prefill=prefill_counts,
        launches_decode_step=step_counts, first_stream=res.tokens[0, :12].tolist(),
    )

    # (a) layer 0's real q/k/v through the kernel and its plain version
    lp = params.layer(0)
    x = params.embed[prompts.long()].to(cfg.cdtype)
    pos = torch.arange(prompt_len, dtype=torch.int32, device=device)
    q, kk, v = tm.project_qkv(lp, common.rms_norm(x, lp["ln1"]), pos, cfg)
    q, kk, v = (t.transpose(1, 2).contiguous() for t in (q, kk, v))
    scale = cfg.head_dim**-0.5
    attn = flash_attention(q, kk, v, True, None, scale, round_scores=True)
    want = flash_attention_plain(q, kk, v, True, None, scale, round_scores=True)
    flash_err = (attn.float() - want.float()).abs().max().item()
    row_ratio = flash_row_check(attn, want, "at the MoE prefill's layer 0")
    # the row check must see a window cut at the last rows: the plain version
    # with window S - cut, from 64 keys doubling, must fail it
    cut = 64
    while True:
        if cut >= prompt_len:
            raise AssertionError("the flash row check passes every window cut")
        cut_worst, cut_ratio = flash_rows(
            flash_attention_plain(q, kk, v, True, prompt_len - cut, scale,
                                  round_scores=True), want)
        if cut_worst > 1.0:
            break
        cut *= 2
    del want

    # (b) layer 0's MoE FFN on its real ln2 input
    a = attn.transpose(1, 2).reshape(batch, prompt_len, -1) @ lp["wo"]
    hn = common.rms_norm(x + a, lp["ln2"]).reshape(n_prompt, cfg.d_model)
    del a, x
    mp = tm.moe_params(lp)
    y, _ = moe.moe_ffn(hn, mp, mcfg)
    with plain_graph_kernels():
        y_plain, _ = moe.moe_ffn(hn, mp, mcfg)
    y_scale = y_plain.abs().max().item()
    y_err = (y.float() - y_plain.float()).abs().max().item()
    if not y_err <= TOL[cfg.cdtype] * y_scale:
        raise AssertionError(f"moe_ffn on the kernels against the plain versions: max|Δ| "
                             f"{y_err} > {TOL[cfg.cdtype]}·{y_scale}")
    del y_plain
    cap = moe.capacity(n_prompt, mcfg)
    idx, gate, _ = moe.route(hn, mp["router"], mcfg)
    pos_e, keep = moe.dispatch_indices(idx, e, cap)
    # the keep mask on the host: each expert keeps min(count, cap) slots,
    # its first cap in (token, slot) order, at positions 0, 1, ...
    flat_h, keep_h, pos_h = (t.cpu().numpy() for t in (idx.reshape(-1), keep, pos_e))
    for ex in range(e):
        mine = np.flatnonzero(flat_h == ex)
        if not (np.array_equal(keep_h[mine], np.arange(mine.size) < cap)
                and np.array_equal(pos_h[mine], np.arange(mine.size))):
            raise AssertionError(f"moe: expert {ex}'s keep mask is not its first {cap} slots")
    counts_e = np.bincount(flat_h, minlength=e)
    # float64 oracle: each kept (token, expert) SwiGLU densely from the
    # weights, gate-weighted, plus the shared experts
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    toks = torch.randperm(n_prompt, generator=gen, device=device)[:MOE_ORACLE_TOKENS]
    xs = hn[toks].double()
    ids, gs = idx[toks], gate[toks].double()
    ks = keep.reshape(n_prompt, k)[toks]
    oracle = torch.zeros_like(xs)
    for ex in range(e):
        rows, slots = ((ids == ex) & ks).nonzero(as_tuple=True)
        if rows.numel():
            xe = xs[rows]
            h = F.silu(xe @ mp["w1"][ex].double()) * (xe @ mp["w3"][ex].double())
            oracle.index_add_(0, rows, gs[rows, slots, None] * (h @ mp["w2"][ex].double()))
    sh = {name: w.double() for name, w in mp["shared"].items()}
    oracle += common.swiglu(xs, sh["w1"], sh["w3"], sh["w2"])
    o_scale = oracle.abs().max().item()
    o_err = (y[toks].double() - oracle).abs().max().item()
    if not o_err <= TOL[cfg.cdtype] * o_scale:
        raise AssertionError(f"moe_ffn against the float64 oracle: max|Δ| {o_err} > "
                             f"{TOL[cfg.cdtype]}·{o_scale}")
    del oracle, xs, sh, y
    layer = {"hn": hn, "idx": idx, "gate": gate, "pos": pos_e, "keep": keep, "cap": cap,
             "params": mp, "q": q, "k": kk, "v": v, "scale": scale, "flash_err": flash_err}
    say("moe_checks", card, ok=True, flash_max_abs_err=flash_err,
        flash_max_row_ratio=row_ratio, flash_row_limit=list(FLASH_ROW[cfg.cdtype]),
        window_cut_caught=cut, window_cut_row_ratio=cut_ratio,
        window_cut_worst_over_limit=cut_worst,
        ffn_versus_plain_max_abs_diff=y_err, ffn_max_abs=y_scale,
        ffn_tol=TOL[cfg.cdtype], oracle_tokens=MOE_ORACLE_TOKENS,
        oracle_max_abs_diff=o_err, oracle_max_abs=o_scale,
        layer0_expert_capacity=cap, layer0_dropped=int((~keep).sum()),
        layer0_largest_expert=int(counts_e.max()), layer0_smallest_expert=int(counts_e.min()))

    rows = moe_kernel_rows(layer, serve_counts) if device.type == "cuda" else []
    say("moe_kernels", card, rows=rows)
    del layer

    # (c) The comparison can be no tighter than two prefills of the same
    # tokens at two batch shapes, which differ by roundings that 28 bf16
    # layers amplify to a few % of a logit row. The served flash path
    # rounds each prefill score to bf16 as the decode step's dense
    # attention does (round_scores, ROADMAP C-F6), so the prefill and the
    # step score alike and position 0 (prefill against prefill) measures
    # that floor: the served path is the check.
    served = moe_teacher_forced(params, cfg, prompts, steps)
    say("moe_teacher_forced", card, checked=True, **served)
    if not served["within_limit"]:
        raise AssertionError(f"moe decode against the teacher-forced prefill: {served}")
    del params
    say("moe_phase", card, seconds=time.perf_counter() - t_phase)
    return rows


def moe_teacher_forced(params, cfg, prompts, steps):
    """Serve ``prompts`` with ``cfg`` at ``capacity_factor = E / k`` (every
    expert's capacity ≥ T: no slot dropped, which the counters confirm),
    then compare each decode step's logits and the greedy tokens with one
    teacher-forced prefill over the prompts and the fed tokens, as the LM
    path does. In bf16 a decode step and the prefill differ by roundings,
    and a token whose k-th and (k+1)-th experts are that close takes the
    other expert in one of them; the output then jumps by that expert's
    gated difference. So the prefill's routing is pinned to the serve's
    (:func:`moe_routes`: its own probabilities at the served experts), and
    the flips it would have made are counted with their margins. Returns
    the comparison's numbers; ``within_limit`` is the LM path's test (every
    logit within ``TOL``·max|ref|, the greedy tokens equal where the
    reference's top-2 margin is larger)."""
    from repro_torch.launch import serve as srv
    from repro_torch.models.transformer import model as tm

    b, prompt_len = prompts.shape
    n_layers, k = cfg.n_layers, cfg.moe.top_k
    nd = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / k))
    log = []
    moe_counters(zero=True)
    with moe_routes(log):
        res = srv.serve(params, nd, prompts, steps)
    # a prefill's ids per layer, then each decode step's, over (b, position)
    pins = [torch.cat([log[i].reshape(b, prompt_len, k)]
                      + [log[n_layers * (1 + s) + i].reshape(b, 1, k) for s in range(steps)],
                      dim=1).reshape(-1, k) for i in range(n_layers)]
    del log
    fed = torch.cat([prompts, res.tokens[:, :steps]], dim=1)
    flips = []
    with moe_routes(flips, pins):
        ref = tm.prefill(params, fed, nd, full_logits=True)[0]
    dropped = moe_counters()["moe_dropped"]
    if dropped != 0:
        raise AssertionError(f"moe (c): {dropped} slots dropped at capacity factor E/k")
    del pins
    ref = ref[:, prompt_len - 1:].float()  # [B, steps + 1, V]
    got = torch.stack([lg.float() for lg in res.logits], dim=1)
    scale = ref.abs().max().item()
    atol = TOL[cfg.cdtype] * scale
    diff = (got - ref).abs()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > atol
    agree = ref.argmax(-1).to(torch.int32) == res.tokens
    differ = torch.stack([f for f, _ in flips]).reshape(n_layers, b, -1)  # [L, B, S + steps]
    gap = torch.stack([g for _, g in flips]).reshape(n_layers, b, -1)
    dec, pro = differ[:, :, prompt_len:], differ[:, :, :prompt_len]
    # per position, the largest ‖Δ‖ / ‖ref‖ over the batch; position 0 is
    # the serve's prefill against the reference (no decode step between)
    row_rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).amax(0)
    return {
        "within_limit": diff.max().item() <= atol and bool(agree[decided].all()),
        "attn_impl": cfg.attn_impl, "capacity_factor": nd.moe.capacity_factor,
        "prompt_len": prompt_len, "steps": steps, "dropped": dropped,
        "logits_max_abs_diff": diff.max().item(), "logits_tol": atol, "logits_max_abs": scale,
        "row_rel_err_max": row_rel[1:].max().item(), "row_rel_err_position0": row_rel[0].item(),
        "positions": int(decided.numel()), "greedy_checked": int(decided.sum().item()),
        "greedy_agree_all": int(agree.sum().item()),
        "flips_decoded_pairs": int(dec.sum()), "decoded_pairs": dec.numel(),
        "flips_decoded_positions": int(dec.any(0).sum()), "decoded_positions": dec[0].numel(),
        "flips_prompt_pairs": int(pro.sum()), "prompt_pairs": pro.numel(),
        "flip_gap_max": float(gap[differ].max()) if bool(differ.any()) else None,
        "gap_median": float(gap.median()),
    }


#: each kernel's source and the TPU kernel it replaces
KERNEL_FILES = {
    "gather_rows": ("src/repro_torch/csrc/gather_rows.cu",
                    "src/repro/kernels/gather_rows/kernel.py:20"),
    "segment_reduce": ("src/repro_torch/csrc/segment_reduce.cu",
                       "src/repro/kernels/segment_reduce/kernel.py:55"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:103"),
}


def moe_kernel_rows(layer, launches):
    """The three kernels at the MoE prefill's layer-0 shapes, each first
    held to its plain version: ``gather_rows`` ``scalar`` of the dispatch
    (fill mode, ``[E·C, 2048]`` bf16 from the ``[T, 2048]`` ``ln2``
    input, the inverse map built here by a boolean index and held to
    ``moe.dispatch``), of the combine read (clip mode, ``[T·k, 2048]`` from
    the expert outputs), ``segment_reduce`` ``cols`` of the gate-weighted
    rows (``[T·k, 2048]`` → ``[T, 2048]``, k rows a segment) and
    ``flash_attention`` on layer 0's q/k/v (``[4, 16, 6144, 128]``,
    causal). Each beside its bound (a gather reads each distinct row once),
    its plain version and its library call (``index_select``, on a table
    padded with a zero row for the fill mode; ``index_add_`` in place;
    ``scaled_dot_product_attention``, causal). ``launches`` are one serve's;
    a gather row takes half of ``gather_rows``', one launch a layer a pass
    for each of the two gathers."""
    import torch.nn.functional as F

    from repro_torch.kernels import (
        flash_attention, flash_attention_plain, gather_rows, gather_rows_plain,
        segment_reduce, segment_reduce_plain,
    )
    from repro_torch.models.transformer import moe

    hn, idx, gate, pos, keep, cap, mp = (layer[name] for name in (
        "hn", "idx", "gate", "pos", "keep", "cap", "params"))
    t, d = hn.shape
    e, k = mp["w1"].shape[0], idx.shape[1]
    elem = hn.element_size()
    token_id = torch.arange(t, dtype=torch.int32, device="cuda").repeat_interleave(k)
    slot = torch.where(keep, idx.reshape(-1) * cap + pos, e * cap)
    src = torch.full((e * cap,), t, dtype=torch.int32, device="cuda")
    src[slot[keep].long()] = token_id[keep]

    def row(name, case, fn, plain, library, library_name, nbytes, nops, n_launches, err,
            shape, kernel_route, ops_per_s=SCALAR_OPS_PER_S, **extra):
        b_ms, by = bound(nbytes, nops, ops_per_s)
        ms = cuda_ms(fn, reps=10)
        source, replaces = KERNEL_FILES[name]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": "moe", "case": case, "launches": n_launches, "max_abs_err": err,
            "ms": ms, "plain_ms": cuda_ms(plain, reps=3), "bound_ms": b_ms, "bound_by": by,
            "library_ms": cuda_ms(library, reps=10), "library": library_name,
            "shape": shape, "kernel_route": kernel_route, "bound_share": b_ms / ms,
            "gb_s": nbytes / ms / 1e6, **extra,
        }

    # dispatch: the expert input, zero rows where no token landed
    got = gather_rows(hn, src, 0)
    want = gather_rows_plain(hn, src, 0)
    if not (torch.equal(got, want) and torch.equal(got, moe.dispatch(hn, slot, token_id, e * cap))):
        raise AssertionError("gather_rows (moe dispatch) disagrees with its plain version")
    distinct = int(torch.unique(src[src < t]).numel())
    padded = torch.cat([hn, hn.new_zeros((1, d))])
    rows = [row("gather_rows", "moe dispatch, fill mode", lambda: gather_rows(hn, src, 0),
                lambda: gather_rows_plain(hn, src, 0),
                lambda: torch.index_select(padded, 0, src), "index_select on a padded table",
                distinct * d * elem + src.numel() * (4 + d * elem), 0,
                launches["gather_rows_scalar"] // 2, float((got - want).abs().max()),
                f"table bf16[{t}, {d}], idx i32[{e * cap}] ({e} experts × {cap})", "scalar",
                distinct_rows=distinct)]
    del padded, want

    # the experts, then the combine read of each (token, slot)'s row
    xin = got.reshape(e, cap, d)
    h = F.silu(torch.bmm(xin, mp["w1"])) * torch.bmm(xin, mp["w3"])
    out_slots = torch.bmm(h, mp["w2"]).reshape(e * cap, d)
    del xin, h, got
    cidx = slot.clamp(max=e * cap - 1)
    got = gather_rows(out_slots, cidx)
    want = gather_rows_plain(out_slots, cidx)
    if not torch.equal(got, want):
        raise AssertionError("gather_rows (moe combine) disagrees with its plain version")
    distinct = int(torch.unique(cidx).numel())
    rows.append(row("gather_rows", "moe combine read, clip mode",
                    lambda: gather_rows(out_slots, cidx),
                    lambda: gather_rows_plain(out_slots, cidx),
                    lambda: torch.index_select(out_slots, 0, cidx), "index_select",
                    distinct * d * elem + cidx.numel() * (4 + d * elem), 0,
                    launches["gather_rows_scalar"] // 2, float((got - want).abs().max()),
                    f"table bf16[{e * cap}, {d}], idx i32[{t * k}]", "scalar",
                    distinct_rows=distinct))
    del out_slots, want

    # the combine: k gate-weighted rows a token
    vals = got.mul_((gate.reshape(-1) * keep).to(hn.dtype)[:, None])
    offsets = torch.arange(0, k * (t + 1), k, dtype=torch.int32, device="cuda")
    sgot = segment_reduce(vals, token_id, t, "sum", offsets=offsets)
    swant = segment_reduce_plain(vals, token_id, t, "sum")
    mag = segment_reduce(vals.abs(), token_id, t, "sum", offsets=offsets).float()
    if not bool(((sgot.float() - swant.float()).abs() <= TOL[hn.dtype] * mag).all()):
        raise AssertionError("segment_reduce (moe combine) disagrees with its plain version")
    err = float((sgot.float() - swant.float()).abs().max())
    del swant, mag
    buf = torch.zeros((t, d), dtype=hn.dtype, device="cuda")
    rows.append(row("segment_reduce", "moe combine sum",
                    lambda: segment_reduce(vals, token_id, t, "sum", offsets=offsets),
                    lambda: segment_reduce_plain(vals, token_id, t, "sum"),
                    lambda: buf.index_add_(0, token_id, vals), "index_add_ in place",
                    vals.numel() * elem + offsets.numel() * 4 + t * d * elem, vals.numel(),
                    launches["segment_reduce_cols"], err,
                    f"values bf16[{t * k}, {d}] sum, {t} segments of {k} rows", "cols"))
    del buf, vals, sgot, got

    # flash on layer 0's q/k/v: causal, no window, D = 128, MHA
    q, kk, v, scale = layer["q"], layer["k"], layer["v"], layer["scale"]
    b, nh, sq, dh = q.shape
    pairs = sq * (sq + 1) // 2
    flops = pairs * b * nh * 4 * dh
    lib = F.scaled_dot_product_attention(q, kk, v, is_causal=True, scale=scale)
    lib_err = float((lib.float() - flash_attention(q, kk, v, True, None, scale,
                                                   round_scores=True).float()).abs().max())
    del lib
    rows.append(row("flash_attention", "moe prefill attention",
                    lambda: flash_attention(q, kk, v, True, None, scale, round_scores=True),
                    lambda: flash_attention_plain(q, kk, v, True, None, scale,
                                                  round_scores=True),
                    lambda: F.scaled_dot_product_attention(q, kk, v, is_causal=True, scale=scale),
                    "scaled_dot_product_attention(is_causal)",
                    (q.numel() * 2 + kk.numel() + v.numel()) * elem, flops,
                    launches["flash_attention"], layer["flash_err"],
                    f"q bf16[{b},{nh},{sq},{dh}], kv the same, causal, no window",
                    "tc (TMA + wgmma)",
                    ops_per_s=BF16_TENSOR_OPS_PER_S, library_max_abs_diff=lib_err,
                    kept_pairs_per_head=pairs))
    rows[-1]["tflops"] = flops / rows[-1]["ms"] / 1e9
    rows[-1].update(rounding_cost(
        lambda: flash_attention(q, kk, v, True, None, scale, round_scores=True),
        lambda: flash_attention(q, kk, v, True, None, scale)))
    return rows


def rounding_cost(rounded, f32_scores) -> dict:
    """The flash forward with its scores rounded to bf16 (the model's) and
    with f32 scores (the TPU kernel's), timed in turns (rounded, f32, f32,
    rounded) in this call."""
    t = [cuda_ms(fn, reps=10) for fn in (rounded, f32_scores, f32_scores, rounded)]
    return {"rounded_ms": [t[0], t[3]], "f32_scores_ms": [t[1], t[2]],
            "rounding_cost": (t[0] + t[3]) / (t[1] + t[2]) - 1}


# -- 5. AutoInt serving --------------------------------------------------------


def numpy_autoint(params, fields, cfg, pooled=False):
    """Independent float64 forward of AutoInt over the rows ``fields`` read
    (clipped flat indices into the stacked table, as the JAX package)."""
    f, v, d = params["tables"].shape
    flat = np.clip(fields.astype(np.int64) + np.arange(f) * v, 0, f * v - 1)
    rows = params["tables"].reshape(f * v, d)[
        torch.from_numpy(flat.reshape(-1)).to(params["tables"].device)
    ]
    x = rows.cpu().numpy().astype(np.float64).reshape(fields.shape + (d,))
    np64 = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
    for lp in params["attn"]:
        b = x.shape[0]
        heads = lambda w: (x @ np64(w)).reshape(b, f, cfg.n_heads, cfg.d_head)  # noqa: E731
        q, k, vv = heads(lp["wq"]), heads(lp["wk"]), heads(lp["wv"])
        s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(cfg.d_head)
        a = np.exp(s - s.max(-1, keepdims=True))
        a /= a.sum(-1, keepdims=True)
        o = np.einsum("bhqk,bkhd->bqhd", a, vv).reshape(b, f, -1)
        x = np.maximum(o + x @ np64(lp["w_res"]), 0.0)
    if pooled:
        return x.mean(axis=1)
    h = x.reshape(x.shape[0], -1)
    for lp in params["mlp"]:
        h = np.maximum(h @ np64(lp["w"]) + np64(lp["b"]), 0.0)
    return (h @ np64(params["head"]))[:, 0]


def host_ms(fn, device, reps):
    """Host-clock time of ``fn`` to its last kernel, after one warm call."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def autoint_path(cfg, shapes, seed, device, card):
    """``serve_p99``, ``serve_bulk`` and ``retrieval_cand`` through
    ``repro_torch.models.recsys.autoint`` with float64 numpy oracles."""
    from repro_torch.data import recsys_batches
    from repro_torch.kernels import embedding_bag
    from repro_torch.models.recsys import autoint as ai

    sync(device)
    t0 = time.perf_counter()
    params = ai.init(cfg, seed=seed, device=device)
    batches = {
        name: next(recsys_batches(shapes[name]["batch"], cfg.n_fields,
                                  cfg.vocab_per_field, seed=seed + i, device=device))
        for i, name in enumerate(("serve_p99", "serve_bulk", "retrieval_cand"))
    }
    gen = torch.Generator(device=device).manual_seed(seed)
    n_cand = shapes["retrieval_cand"]["n_candidates"]
    cands = torch.randn((n_cand, cfg.d_attn), generator=gen, device=device)
    sync(device)
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    for counter in ("launches", "launches_vec", "launches_scalar"):
        setattr(embedding_bag, counter, 0)
    p99 = ai.forward(params, batches["serve_p99"], cfg)
    bulk = ai.forward(params, batches["serve_bulk"], cfg)
    retr = {"fields": batches["retrieval_cand"]["fields"], "candidates": cands}
    scores, ids = ai.retrieval_score(params, retr, cfg, top_k=100)
    sync(device)
    launches, launches_vec = embedding_bag.launches, embedding_bag.launches_vec
    if device.type == "cuda" and launches <= 0:
        raise AssertionError("the AutoInt path never launched embedding_bag")
    if device.type == "cuda" and launches_vec != launches:
        raise AssertionError(f"{launches - launches_vec} of the AutoInt path's "
                             f"{launches} embedding_bag launches on the scalar route")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None

    t0 = time.perf_counter()
    for name, got in (("serve_p99", p99), ("serve_bulk", bulk)):
        if tuple(got.shape) != (shapes[name]["batch"],) or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: logits of shape {tuple(got.shape)} or not finite")
    fields = batches["serve_p99"]["fields"].cpu().numpy()
    want = numpy_autoint(params, fields, cfg)
    np.testing.assert_allclose(p99.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    bulk_head = batches["serve_bulk"]["fields"][:512].cpu().numpy()
    np.testing.assert_allclose(bulk[:512].cpu().numpy(), numpy_autoint(params, bulk_head, cfg),
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())
    query = numpy_autoint(params, retr["fields"].cpu().numpy(), cfg, pooled=True)
    all_scores = (cands.cpu().numpy().astype(np.float64) @ query[0])
    order = np.argsort(-all_scores, kind="stable")[:101]
    got_ids = ids[0].cpu().numpy()
    span = np.abs(all_scores[order[0]])
    # the same 100 candidates, in the oracle's order, up to f32 rounding
    np.testing.assert_allclose(all_scores[got_ids], all_scores[order[:100]],
                               rtol=0, atol=1e-5 * span)
    np.testing.assert_allclose(scores[0].cpu().numpy(), all_scores[order[:100]],
                               rtol=1e-4, atol=1e-5 * span)
    if len(set(got_ids.tolist())) != 100:
        raise AssertionError("retrieval returned a candidate twice")
    check_s = time.perf_counter() - t0

    b99, bbulk = shapes["serve_p99"]["batch"], shapes["serve_bulk"]["batch"]
    p99_ms = host_ms(lambda: ai.forward(params, batches["serve_p99"], cfg), device, 20)
    bulk_ms = host_ms(lambda: ai.forward(params, batches["serve_bulk"], cfg), device, 3)
    retr_ms = host_ms(lambda: ai.retrieval_score(params, retr, cfg, top_k=100), device, 5)
    if device.type == "cuda":
        for name in ("serve_p99", "serve_bulk"):
            device_busy(lambda: ai.forward(params, batches[name], cfg),
                        f"autoint {name}", card)
    say(
        "autoint_serve", card, arch=cfg.name, embedding_bag_launches=launches,
        embedding_bag_launches_vec=launches_vec,
        setup_s=setup_s, check_s=check_s, peak_allocated_gb=peak_gb,
        serve_p99_ms=p99_ms, serve_p99_rows_s=b99 / p99_ms * 1e3,
        serve_bulk_ms=bulk_ms, serve_bulk_rows_s=bbulk / bulk_ms * 1e3,
        retrieval_ms=retr_ms, n_candidates=n_cand,
        retrieval_exact_ids=bool(np.array_equal(got_ids, order[:100])),
        top100_min_gap=float(np.min(-np.diff(all_scores[order]))),
    )
    f, v, d = params["tables"].shape
    flat_idx = (batches["serve_bulk"]["fields"]
                + torch.arange(f, dtype=torch.int32, device=device) * v).reshape(-1, 1)
    return {"launches": launches, "table": params["tables"].reshape(f * v, d),
            "idx": flat_idx.contiguous()}


# -- 6. kernel times of the model paths ------------------------------------------


def model_kernel_rows(lm, rec):
    """``flash_attention`` at the prefill's first layer and ``embedding_bag``
    at ``serve_bulk``'s lookup: time, plain time, library time, bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import (
        embedding_bag, embedding_bag_plain, flash_attention, flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention import keep_mask
    from repro_torch.kernels.flash_attention.ops import route
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, window, scale = lm["q"], lm["k"], lm["v"], lm["window"], lm["scale"]
    b, h, sq, d = q.shape
    keep = keep_mask(torch.arange(sq, device="cuda"), torch.arange(k.shape[2], device="cuda"),
                     True, window)
    pairs = int(keep.sum())  # the (query, key) pairs kept, per head
    f_bytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    f_bound, f_by = bound(f_bytes, pairs * b * h * 4 * d, BF16_TENSOR_OPS_PER_S)
    n_rep = h // k.shape[1]

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=keep, scale=scale,
                                              enable_gqa=True)

    lib = sdpa()
    lib_err = (lib.float() - flash_attention(q, k, v, True, window, scale,
                                             round_scores=True).float()).abs().max()
    kx, vx = k.repeat_interleave(n_rep, 1), v.repeat_interleave(n_rep, 1)
    expanded_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, attn_mask=keep, scale=scale), reps=10)
    # a harder yardstick: PyTorch's FlashAttention backend, causal without
    # the window (it has no window), so it computes more pairs than the kernel
    causal_pairs = sq * (sq + 1) // 2
    causal = {}
    for name, (kk, vv, gqa) in (("library_causal", (k, v, True)),
                                ("library_causal_expanded_kv", (kx, vx, False))):
        def sdpa_causal(kk=kk, vv=vv, gqa=gqa):
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(q, kk, vv, is_causal=True,
                                                      scale=scale, enable_gqa=gqa)
        try:
            sdpa_causal()
            causal[f"{name}_ms"] = cuda_ms(sdpa_causal, reps=10)
        except RuntimeError as exc:  # the backend refuses this call: say so
            causal[f"{name}_ms"] = None
            causal[f"{name}_refused"] = str(exc).splitlines()[0][:300]
    del kx, vx
    flops = pairs * b * h * 4 * d
    ms = cuda_ms(lambda: flash_attention(q, k, v, True, window, scale, round_scores=True),
                 reps=10)
    rounding = rounding_cost(lambda: flash_attention(q, k, v, True, window, scale,
                                                     round_scores=True),
                             lambda: flash_attention(q, k, v, True, window, scale))
    rows = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": lm["launches"],
        "max_abs_err": lm["max_abs_err"],
        "ms": ms,
        "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, True, window, scale,
                                                          round_scores=True), reps=3),
        "bound_ms": f_bound,
        "bound_by": f_by,
        "library_ms": cuda_ms(sdpa, reps=10),
        "shape": f"q bf16[{b},{h},{sq},{d}], kv [{b},{k.shape[1]},{k.shape[2]},{d}], "
                 f"causal, window {window}, {pairs} live pairs/head",
        "library": "scaled_dot_product_attention(enable_gqa, bool mask)",
        "library_max_abs_diff": float(lib_err),
        "library_expanded_kv_ms": expanded_ms,
        **causal,
        "library_causal_pairs_per_head": causal_pairs,
        **rounding,
        "kept_pairs_per_head": pairs,
        "kernel_route": "tc (TMA + wgmma)" if route(q.dtype, d) == "tc" else "simt",
        "tflops": flops / ms / 1e9,
        "bound_share": f_bound / ms,
    }]
    del lib

    table, idx = rec["table"], rec["idx"]
    vec_before = embedding_bag.launches_vec
    got = embedding_bag(table, idx)
    bag_route = "vec" if embedding_bag.launches_vec > vec_before else "scalar"
    want = embedding_bag_plain(table, idx)
    if not torch.equal(got, want):
        raise AssertionError("embedding_bag disagrees with its plain version at serve_bulk")
    n, d = idx.shape[0], table.shape[1]
    distinct, e_bytes = bag_bytes(table, idx)
    e_bound, e_by = bound(e_bytes, idx.numel() * d, SCALAR_OPS_PER_S)
    per_slot = bound(n * d * table.element_size() * 2 + idx.numel() * 4, 0)[0]
    ms = cuda_ms(lambda: embedding_bag(table, idx))
    rows.append({
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:42",
        "launches": rec["launches"],
        "max_abs_err": float((got - want).abs().max()),
        "ms": ms,
        "plain_ms": cuda_ms(lambda: embedding_bag_plain(table, idx)),
        "bound_ms": e_bound,
        "bound_by": e_by,
        "library_ms": cuda_ms(lambda: F.embedding_bag(idx, table, mode="sum")),
        "shape": f"table f32[{table.shape[0]},{d}], {n} one-slot bags (serve_bulk lookup)",
        "library": "embedding_bag(mode='sum')",
        "kernel_route": bag_route,
        "distinct_rows": distinct,
        "bound_share": e_bound / ms,
        "gb_s": e_bytes / ms / 1e6,
        "bound_ms_per_slot": per_slot,
    })
    return rows


def bag_bytes(table, idx, weighted: bool = False):
    """``(distinct rows, bytes)`` an ``embedding_bag`` call must move: each
    distinct (clipped) row its ids name read once, the ids and weights read
    once, the output written once. The distinct rows are counted on the card
    by ``torch.unique``, outside any timed window."""
    v, d = table.shape
    elem = table.element_size()
    distinct = int(torch.unique(idx.reshape(-1).clamp(0, v - 1)).numel())
    nbytes = (distinct * d * elem + idx.shape[0] * d * elem + idx.numel() * 4
              + (idx.numel() * elem if weighted else 0))
    return distinct, nbytes


# -- 7. training: the backward kernels and four trainers -------------------------

TRAIN_STEPS = 8
#: LM_SHAPES["train_4k"]'s 4,096-token sequences at a batch of 4: its global
#: batch of 256 cut to one card (JAX's trainer has no accumulation)
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 4096
#: gat-cora's training batch: ``build``'s full graph of 16 · 256 nodes at
#: the Cora shape (1,433 features, 7 classes)
GAT_TRAIN_BATCH = 256
#: AdamW's rate (JAX's trainer default) and a short warmup; the LM takes a
#: tenth of it: at 3e-4 its first AdamW steps move every one of a 2,560-wide
#: layer's weights by the rate in a concerted direction, and from random
#: weights its loss spikes within eight steps
TRAIN_LR, LM_TRAIN_LR, TRAIN_WARMUP = 3e-4, 3e-5, 2
#: step 0 with the kernels against the same step with every kernel's plain
#: version: loss and global gradient norm, relative. bf16 (h2o-danube):
#: both attentions round P to bf16 at the same place, the sums run in other
#: orders through 24 layers (measured 2e-5); f32: summation orders only
TRAIN_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
#: flash backward sweep (b, h, hkv, s, d, window): h2o-danube's heads (D =
#: 80, 32/8) and deepseek-moe's (D = 128, 16/16) at S on the 64-row query
#: and 128-key tiles' edges, S past the window, and D = 72 (8/2) and D = 40
#: (4/1), odd multiples of 8 that the tensor-core route rounds up to 16
#: (``bwd_route``: bf16 with D % 8 == 0)
FLASH_BWD_CASES = [
    (1, 32, 8, 63, 80, None), (1, 32, 8, 64, 80, 4096), (2, 32, 8, 129, 80, 4096),
    (1, 32, 8, 700, 80, 200), (1, 16, 16, 65, 128, None), (1, 16, 16, 256, 128, None),
    (1, 16, 16, 300, 128, 100), (1, 8, 2, 130, 72, 64), (2, 4, 1, 257, 40, None),
]
#: the R-MAT hub's in-degree (vertex 0 at scale 22), as one id of a gather
HUB_IDS = 163_558


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper, forward and backward, pointed at its plain
    version (the module attributes ``kernels.autograd`` calls)."""
    from repro_torch.kernels.embedding_bag import ops as b
    from repro_torch.kernels.flash_attention import ops as f

    saved = f.flash_attention, f.flash_attention_bwd, b.embedding_bag
    f.flash_attention, f.flash_attention_bwd, b.embedding_bag = (
        f.flash_attention_plain, f.flash_attention_bwd_plain, b.embedding_bag_plain)
    try:
        with plain_graph_kernels():
            yield
    finally:
        f.flash_attention, f.flash_attention_bwd, b.embedding_bag = saved


def train_counters(zero: bool = False) -> dict:
    """Every kernel's launch counters per route, and the composed
    backwards' calls (``kernels.autograd``), set to 0 first with ``zero``."""
    from repro_torch.kernels import autograd as kg
    from repro_torch.kernels import embedding_bag, flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    out = graph_counters(zero)
    names = {
        flash_attention: ("launches", "launches_tc", "launches_simt"),
        flash_attention_bwd: ("launches", "launches_tc", "launches_simt"),
        embedding_bag: ("launches", "launches_vec", "launches_scalar"),
        kg.gather_rows_backward: ("calls",),
        kg.segment_reduce_backward: ("calls",),
        kg.embedding_bag_backward: ("calls",),
    }
    for fn, counters in names.items():
        for counter in counters:
            if zero:
                setattr(fn, counter, 0)
            key = fn.__name__ + ("" if counter in ("launches", "calls") else counter[8:])
            out[key] = getattr(fn, counter)
    return out


def host_scatter(g, rows, n, device="cpu"):
    """``(Σ g, Σ |g|)`` of the rows of ``g`` by ``rows`` into ``n`` rows, in
    float64 on ``device`` (the host unless told); rows outside ``[0, n)``
    dropped."""
    g64 = g.double().to(device).reshape(g.shape[0], -1)
    rows = rows.long().to(device)
    ok = (rows >= 0) & (rows < n)
    out = torch.zeros((n, g64.shape[1]), dtype=torch.float64, device=device)
    mag = torch.zeros_like(out)
    out.index_add_(0, rows[ok], g64[ok])
    mag.index_add_(0, rows[ok], g64[ok].abs())
    return out, mag


def hold_sum(got, want, mag, exact: bool, what: str):
    """A float sum on the card against its float64 oracle (on the host or
    the card): exact for k/16 values, else within ``TOL`` · Σ|x| of each
    element."""
    got = got.double().to(want.device).reshape(want.shape)
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from the exact sum by "
                                 f"{float((got - want).abs().max())}")
        return 0.0
    err = (got - want).abs()
    if not bool((err <= TOL[torch.float32] * mag + 1e-30).all()):
        raise AssertionError(f"{what}: a sum differs by more than TOL · Σ|x|")
    return float(err.max())


def lse_unchanged(with_lse, without, what):
    """Fails unless the forward's output with ``return_lse=True`` is bit
    for bit the output without it."""
    if not torch.equal(with_lse, without):
        raise AssertionError(f"flash forward {what}: writing the lse changed the output "
                             f"by {float((with_lse.float() - without.float()).abs().max())}")


def grad_row_ratio(got, want) -> float:
    """The largest ‖got − want‖ / ‖want‖ over the gradient rows whose norm
    is at least 1e-3 of the largest (rows of keys that almost no query
    weighs sit at the ``FLASH_ROW`` floor instead)."""
    err = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    big = ref >= 1e-3 * ref.max()
    return float((err[big] / ref[big]).max()) if bool(big.any()) else 0.0


def check_backward_kernels(device, gen, flash_only=False):
    """Each backward on the card against its plain twin over a sweep, each
    run twice and bit-equal: flash (``FLASH_BWD_CASES``, bf16 and f32, with
    f32 scores and with the scores rounded as the model rounds them, each
    gradient row by row within ``FLASH_ROW`` of the plain backward on the same
    inputs, each case on the route ``bwd_route`` names, which must be the C
    entry's rule); the gather's and the bag's table gradients (a hub id
    ``HUB_IDS`` times, Zipf ids, ids -1, V and 2³¹−1 clipped or dropped; exact
    for k/16 values, ``TOL`` · Σ|x| of a float64 host sum for random ones; the
    bag's weights gradient too); segment max and min with planted ties, masked
    and not, on both routes, bit-equal to the same backward on the CPU
    (``flash_only``: flash alone). Returns the cases per kernel and flash's
    largest row ratio per dtype."""
    from repro_torch.kernels import autograd as kg
    from repro_torch.kernels.flash_attention import ops as fl

    cases = {"flash_attention_bwd": 0, "gather_rows_bwd": 0, "embedding_bag_bwd": 0,
             "segment_reduce_bwd": 0}
    ratio = {}

    def rnd(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen).to(dt).to(device)

    def twice(fn):
        a, b = fn(), fn()
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            if x is not None and not torch.equal(x, y):
                raise AssertionError("a backward run twice differs")
        return a

    if device.type == "cuda":  # the wrapper's route rule is the C entry's
        import ctypes

        from repro_torch.kernels import build

        uses_tc = build.library("flash_attention_bwd").flash_attention_bwd_uses_tc
        uses_tc.argtypes, uses_tc.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for d in range(1, 129):
                if bool(uses_tc(code, d)) != (fl.bwd_route(dt, d) == "tc"):
                    raise AssertionError(f"backward route rules disagree at {dt}, D={d}")
    for b, h, hkv, s, d, window in FLASH_BWD_CASES:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = rnd((b, h, s, d), dt), rnd((b, hkv, s, d), dt), rnd((b, hkv, s, d), dt)
            do = rnd((b, h, s, d), dt)
            args = (True, window, d**-0.5)
            for rounded in (False, True):
                what = (b, h, hkv, s, d, window, dt, "rounded" if rounded else "f32 scores")
                out, lse = fl.flash_attention(q, k, v, *args, return_lse=True,
                                              round_scores=rounded)
                lse_unchanged(out, fl.flash_attention(q, k, v, *args, round_scores=rounded),
                              what)
                tc_before = fl.flash_attention_bwd.launches_tc
                got = twice(lambda: fl.flash_attention_bwd(q, k, v, out, lse, do, *args,
                                                           round_scores=rounded))
                took = "tc" if fl.flash_attention_bwd.launches_tc > tc_before else "simt"
                if device.type == "cuda" and took != fl.bwd_route(dt, d):
                    raise AssertionError(f"flash backward {(d, dt)} took the {took} route")
                want = fl.flash_attention_bwd_plain(q, k, v, out, lse, do, *args,
                                                    round_scores=rounded)
                for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
                    flash_row_check(g_, w_, f"bwd {name} {what}")
                    ratio[str(dt)] = max(ratio.get(str(dt), 0.0), grad_row_ratio(g_, w_))
                cases["flash_attention_bwd"] += 1
    if flash_only:
        sync(device)
        return cases, ratio

    v, w = 4096, 16
    zipf = torch.from_numpy(np.random.default_rng(1).zipf(1.2, 200_000) % v).to(torch.int32)
    ids = torch.cat([torch.zeros(HUB_IDS, dtype=torch.int32), zipf,
                     torch.tensor([-1, v, 2**31 - 1, -v, -v - 1], dtype=torch.int32)])
    ids = ids[torch.randperm(ids.shape[0], generator=gen)].to(device)
    for fill in (None, 0.0):
        rows = ids.clamp(0, v - 1) if fill is None else torch.where(ids < 0, ids + v, ids)
        for exact in (True, False):
            g = (torch.randint(-16, 17, (ids.shape[0], w), generator=gen).float() / 16
                 if exact else torch.randn((ids.shape[0], w), generator=gen) * 100).to(device)
            got = twice(lambda: kg.gather_rows_backward(g, ids, v, fill))
            want, mag = host_scatter(g, rows, v)
            hold_sum(got, want, mag, exact, f"gather_rows backward fill={fill}")
            cases["gather_rows_bwd"] += 1

    n_bags = 60_000  # bags of 5 slots take 300,000 of the ids
    for slots in (1, 5):
        idx = ids[: n_bags * slots].reshape(n_bags, slots).contiguous()
        weights = None if slots == 1 else (
            torch.randint(-16, 17, (n_bags, slots), generator=gen).float() / 16).to(device)
        table = (torch.randint(-16, 17, (v, w), generator=gen).float() / 16).to(device)
        for exact in (True, False):
            g = (torch.randint(-16, 17, (n_bags, w), generator=gen).float() / 16
                 if exact else torch.randn((n_bags, w), generator=gen) * 100).to(device)
            got_t, got_w = twice(lambda: kg.embedding_bag_backward(g, table, idx, weights))
            slot_g = g.repeat_interleave(slots, 0)
            if weights is not None:
                slot_g = slot_g * weights.reshape(-1, 1)
            want, mag = host_scatter(slot_g, idx.reshape(-1).clamp(0, v - 1), v)
            hold_sum(got_t, want, mag, exact, f"embedding_bag backward, {slots} slots")
            if weights is not None:
                prod = table.double()[idx.long().clamp(0, v - 1)] * g.double()[:, None, :]
                hold_sum(got_w, prod.sum(-1).cpu(), prod.abs().sum(-1).cpu(), exact,
                         "embedding_bag weights backward")
            cases["embedding_bag_bwd"] += 1

    n_seg = 5000
    lengths = torch.randint(0, 9, (n_seg,), generator=gen)
    lengths[7] = 20_000  # a hub segment
    seg_ids = torch.repeat_interleave(torch.arange(n_seg, dtype=torch.int32), lengths)
    offsets = torch.zeros(n_seg + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(lengths, 0)
    for op in ("max", "min"):
        for width in (1, 8):
            shape = (seg_ids.shape[0],) if width == 1 else (seg_ids.shape[0], width)
            vals = torch.randint(-3, 4, shape, generator=gen).float() / 4  # many ties
            for masked in (False, True):
                mask = (torch.rand(seg_ids.shape[0], generator=gen) < 0.7) if masked else None
                g = torch.randn((n_seg,) + shape[1:], generator=gen)
                args = (vals, seg_ids, n_seg, op, mask, offsets)
                out = kg.segment_reduce(*args[:4], mask=mask, offsets=offsets)
                want = kg.segment_reduce_backward(g, vals, out, seg_ids, n_seg, op, mask,
                                                  offsets)
                dev_args = [None if t is None else t.to(device) for t in
                            (g, vals, out, seg_ids, mask, offsets)]
                got = twice(lambda: kg.segment_reduce_backward(
                    dev_args[0], dev_args[1], dev_args[2], dev_args[3], n_seg, op,
                    dev_args[4], dev_args[5]))
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"segment {op} backward (width {width}, masked "
                                         f"{masked}) differs from the CPU's")
                cases["segment_reduce_bwd"] += 1
    sync(device)
    return cases, ratio


def train_run(name, cfg_dtype, params, loss_fn, batches, items, unit, want, device, card,
              lr=TRAIN_LR):
    """``TRAIN_STEPS`` steps of ``launch.train.make_step`` (AdamW, the
    cosine schedule) on ``batches(i)``: (c) first step 0's loss and global
    gradient norm with the kernels against the same with every kernel's
    plain version (``TRAIN_TOL``); every step timed (host clock to the
    synchronised end); the launches per route of all the steps exactly
    ``want`` × steps; every loss finite, the last below the first, and
    the loss of step 0's batch after the steps below its loss before them
    (the batches differ from step to step, so the last step's loss alone
    says little); then one more step under the profiler. Prints a
    ``train`` line."""
    from repro_torch.launch import train as tr
    from repro_torch.optim import AdamWConfig, adamw_init, global_norm

    reset_peak(device)
    t0 = time.perf_counter()
    loss_k, g = tr.value_and_grad(loss_fn, params, batches(0))
    norm_k = float(global_norm(g.values()))
    del g
    with plain_kernels():
        loss_p, g = tr.value_and_grad(loss_fn, params, batches(0))
        norm_p = float(global_norm(g.values()))
    del g
    loss_k, loss_p = float(loss_k), float(loss_p)
    tol = TRAIN_TOL[cfg_dtype]
    if not (abs(loss_k - loss_p) <= tol * abs(loss_p) and abs(norm_k - norm_p) <= tol * norm_p):
        raise AssertionError(f"train {name}: step 0 with the kernels (loss {loss_k}, "
                             f"|g| {norm_k}) against the plain versions (loss {loss_p}, "
                             f"|g| {norm_p}) beyond {tol}")
    check_s = time.perf_counter() - t0

    oc = AdamWConfig(lr=lr)
    state = {"params": params, "opt": adamw_init(params, oc)}
    step = tr.make_step(loss_fn, oc, TRAIN_WARMUP, TRAIN_STEPS)
    sync(device)
    train_counters(zero=True)
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, metrics = step(state, batches(i))
        losses.append(float(metrics["loss"]))
        sync(device)
        step_s.append(time.perf_counter() - t1)
    launches = train_counters()
    peak = peak_gb(device)
    after = float(loss_fn(params, batches(0)))
    if (not all(math.isfinite(x) for x in losses + [after]) or not after < loss_k
            or not losses[-1] < losses[0]):
        raise AssertionError(f"train {name}: losses {losses}, step 0's batch {loss_k} "
                             f"before and {after} after")
    if device.type == "cuda":
        expect = {k: v * TRAIN_STEPS for k, v in want.items()}
        got = {k: launches.get(k, 0) for k in set(launches) | set(expect)}
        expect = {k: expect.get(k, 0) for k in got}
        if got != expect:
            raise AssertionError(f"train {name}: launches {got}, want {expect}")
        device_busy(lambda: step(state, batches(TRAIN_STEPS)), f"train {name} step", card)
    warm = float(np.median(step_s[1:]))
    say("train", card, arch=name, steps=TRAIN_STEPS, losses=losses,
        first_step_ms=step_s[0] * 1e3, warm_step_ms=warm * 1e3,
        **{f"{unit}_per_s": items / warm}, lr=lr, warmup=TRAIN_WARMUP,
        peak_allocated_gb=peak, launches=launches,
        step0={"loss": loss_k, "loss_plain": loss_p, "grad_norm": norm_k,
               "grad_norm_plain": norm_p, "tol": tol, "check_s": check_s,
               "loss_after_steps": after})
    del state
    return launches


def train_path(minibatch, seed, device, card, reduced=False):
    """Train four models at full width (seed ``seed``): h2o-danube-1.8b (24
    layers, d 2560, bf16, remat; ``launch.train.build``'s parameters and
    batches) on ``LM_TRAIN_BATCH`` × ``LM_TRAIN_SEQ`` tokens; gat-cora's
    published config bound at the Cora shape, on ``gnn_full_batch``;
    graphsage-reddit through ``sage_minibatch_loss`` on ``TRAIN_STEPS``
    sampled minibatches of the GNN phase's Reddit-sized graph (``minibatch``: cfg, graph, features,
    labels, seeds a batch; drawn before the steps); AutoInt on
    ``RECSYS_SHAPES``' ``train_batch`` (65,536 rows). ``reduced`` takes the
    reduced configs at small batches: a CPU rehearsal. Returns each
    model's launches."""
    from repro_torch import configs
    from repro_torch.data import gnn_full_batch, gnn_minibatches
    from repro_torch.launch import train as tr
    from repro_torch.models import common
    from repro_torch.models.gnn import models as gm

    t_phase = time.perf_counter()
    out = {}
    lm_b, lm_s = (2, 48) if reduced else (LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    _, cfg, params, loss_fn, batches = tr.build("h2o-danube-1.8b", reduced, lm_b, lm_s,
                                                seed, device)
    n = cfg.n_layers
    out["h2o-danube-1.8b"] = train_run(
        "h2o-danube-1.8b", cfg.compute_dtype, params, loss_fn, batches, lm_b * lm_s,
        "tokens", {"flash_attention": 2 * n, "flash_attention_tc": 2 * n,
                   "flash_attention_bwd": n, "flash_attention_bwd_tc": n}, device, card,
        lr=LM_TRAIN_LR)
    del params, loss_fn, batches
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # gat-cora's published config leaves its dims unbound, which ``build``
    # (as JAX's) does not take: bound here at the Cora shape, with the full
    # batch ``build`` would draw for ``GAT_TRAIN_BATCH``
    spec = configs.get_spec("gat-cora")
    cfg = spec.reduced if reduced else configs.resolve_gnn_config(
        spec.config, "full_graph_sm", spec.shapes["full_graph_sm"])
    params = common.trainable(gm.init(cfg, seed, device))
    fb = gnn_full_batch(16 * (4 if reduced else GAT_TRAIN_BATCH), 6.0, cfg.d_in, cfg.n_out,
                        seed=seed, task=cfg.task, n_out=cfg.n_out, device=device)

    def loss_fn(p, b):
        return gm.loss_fn(p, b, cfg)

    def batches(i):
        return fb

    layers = cfg.n_layers * (2 if cfg.remat else 1)  # the forward again under remat
    # a GAT layer's forward: 5 gathers of [N, H(, D)] rows and 3 [E, H(, D)]
    # segment reductions; its backward: 5 gather backwards (a gather and a
    # segment sum each), 2 segment-sum backwards (a gather each) and the
    # softmax's max backward (2 gathers and a segment sum)
    n_gather = 5 * layers + 9 * cfg.n_layers
    n_segment = 3 * layers + 6 * cfg.n_layers
    out["gat-cora"] = train_run(
        "gat-cora", cfg.compute_dtype, params, loss_fn, batches, batches(0)["x"].shape[0],
        "nodes", {"gather_rows": n_gather, "gather_rows_scalar": n_gather,
                  "segment_reduce": n_segment, "segment_reduce_cols": n_segment,
                  "gather_rows_backward": 5 * cfg.n_layers,
                  "segment_reduce_backward": 3 * cfg.n_layers}, device, card)
    del params, fb

    mcfg, graph, feats, labels, batch_nodes = minibatch
    params = common.trainable(gm.init(mcfg, seed, device))
    data = gnn_minibatches(graph, feats, labels, batch_nodes, mcfg.fanouts,
                           torch.Generator(device=device).manual_seed(seed))
    mbs = [next(data) for _ in range(TRAIN_STEPS + 1)]
    out["graphsage-reddit"] = train_run(
        "graphsage-reddit minibatch", mcfg.compute_dtype, params,
        lambda p, b: gm.sage_minibatch_loss(p, b, mcfg), lambda i: mbs[i], batch_nodes,
        "seeds", {}, device, card)
    del params, mbs, data

    _, cfg, params, loss_fn, batches = tr.build("autoint", reduced, 64 if reduced else 65_536,
                                                0, seed, device)
    out["autoint"] = train_run(
        "autoint", cfg.param_dtype, params, loss_fn, batches,
        batches(0)["fields"].shape[0], "rows",
        {"embedding_bag": 1, "embedding_bag_vec": 1, "gather_rows": 1,
         "gather_rows_scalar": 1, "segment_reduce": 1, "segment_reduce_cols": 1,
         "embedding_bag_backward": 1}, device, card)
    del params, loss_fn, batches
    say("train_phase", card, seconds=time.perf_counter() - t_phase)
    return out


# -- 8. the checkpoint drill ---------------------------------------------------

#: the drill's schedule: the reference's steps; run A stops after
#: ``CKPT_STOP`` (a job cut short, its checkpoint written), run B resumes
#: there and fails once at step index ``CKPT_FAIL``
CKPT_STEPS, CKPT_STOP, CKPT_FAIL = 6, 3, 4
#: h2o-danube-1.8b's parameter paths in the JAX package's tree (``init`` of
#: its config: no biases, no qk-norm, an untied unembedding), the keys of
#: its checkpoints; tests/test_torch_ckpt.py holds them to JAX's
H2O_JAX_PATHS = ("embed", "layers/ffn/w1", "layers/ffn/w2", "layers/ffn/w3", "layers/ln1",
                 "layers/ln2", "layers/wk", "layers/wo", "layers/wq", "layers/wv", "ln_f",
                 "unembed")
#: ``compress_with_feedback`` per leaf: the residual within scale/2, plus
#: the f32 roundings of the division and the product (127·2⁻²⁴ of the
#: scale each)
COMPRESS_SLACK = 1e-4


def tree_bytes(tree) -> int:
    from repro_torch.checkpoint.checkpoint import _flatten

    return sum(t.numel() * t.element_size() for _, t in _flatten(tree))


def ckpt_dir_with_room(need: int):
    """A fresh directory under the temp directory, or else the checkout,
    whichever first has ``need`` bytes free: ``(path, free bytes)``. No
    room anywhere fails the phase."""
    room = {}
    for base in (Path(tempfile.gettempdir()), ROOT):
        room[str(base)] = shutil.disk_usage(base).free
        if room[str(base)] >= need:
            return Path(tempfile.mkdtemp(prefix="ckpt_drill_", dir=base)), room[str(base)]
    raise AssertionError(f"ckpt_drill: two checkpoints need {need / 1e9:.1f} GB; free: "
                         + ", ".join(f"{k} {v / 1e9:.1f} GB" for k, v in room.items()))


@contextlib.contextmanager
def timing(owner, name, spans):
    """``owner.name`` (a function or a bound method) timed while inside:
    each call's ``(start, end)`` on the host clock appended to ``spans``."""
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spans.append((t0, time.perf_counter()))

    setattr(owner, name, timed)
    try:
        yield spans
    finally:
        setattr(owner, name, fn)


def host_memory() -> dict:
    """GiB available on the host (``/proc/meminfo``) and charged to this
    machine's memory group where it has one (files in a memory-backed
    directory count there too)."""
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, value = line.split(":")
            if key in ("MemAvailable", "Shmem"):
                out[key] = int(value.split()[0]) / 2**20
    cgroup = Path("/sys/fs/cgroup/memory.current")
    if cgroup.exists():
        out["cgroup"] = int(cgroup.read_text()) / 2**30
    return out


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns (so that -0.0 and 0.0 differ)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().view(ints[t.element_size()]) if t.is_floating_point() else t.detach()


def ckpt_drill(seed, device, card, reduced=False):
    """Restart-and-replay drill of h2o-danube-1.8b at full width and depth
    (bf16, remat, ``LM_TRAIN_BATCH`` × ``LM_TRAIN_SEQ`` tokens,
    ``LM_TRAIN_LR``) through ``launch.train``: (1) the reference,
    ``CKPT_STEPS`` plain steps of ``make_step``, its state kept on the card;
    after ``CKPT_STOP`` steps an ``AsyncCheckpointer`` saves it, and the
    steps after run while the write goes on (their ms against the warm
    ones'; that checkpoint is deleted after); before them
    ``compress_with_feedback`` over step 0's gradient, each leaf within its
    scale/2 (``COMPRESS_SLACK``); (2) run A, ``launch.train.Supervised`` from
    a fresh build to ``CKPT_STOP`` steps, checkpointing there (a job that
    stops); (3) run B, a fresh build and a new supervisor to ``CKPT_STEPS``
    with a failure injected at ``CKPT_FAIL``: it restores step 3
    (``restarts == 1``), fails, restores step 3 again (``retries == 1``),
    replays 3-5 and saves step 6. Checks: every loss of A and B bit-equal to
    the reference's at its step; B's final parameters and moments, and the
    step-6 checkpoint read back, bit-equal to the reference's; the
    manifest's keys the JAX tree's paths; every flash launch of A and B on
    the tensor cores, exactly 2·L forward and L backward a step. The
    checkpoints go where two fit (temp directory, else the checkout;
    none: the phase fails) and are deleted after. Prints ``ckpt`` and
    ``ckpt_drill`` lines. ``reduced``: the reduced config at a small batch
    (a CPU rehearsal). Returns the launches of runs A and B."""
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.checkpoint import checkpoint as ck_mod
    from repro_torch.checkpoint.checkpoint import _flatten, tree_map
    from repro_torch.ft import failures
    from repro_torch.launch import train as tr
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.grad_compress import compress_with_feedback

    t_phase = time.perf_counter()
    b, s = (2, 48) if reduced else (LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    oc = AdamWConfig(lr=LM_TRAIN_LR)

    def fresh():
        return tr.build("h2o-danube-1.8b", reduced, b, s, seed, device)[1:]

    def now():
        sync(device)
        return time.perf_counter()

    gc.collect()
    cfg, params, loss_fn, batches = fresh()
    n = cfg.n_layers

    # compress_with_feedback over step 0's gradient, one rank
    t0 = now()
    _, g = tr.value_and_grad(loss_fn, params, batches(0))
    grad_ms = (now() - t0) * 1e3
    t0 = now()
    ratios = {}
    for k, gl in g.items():
        _, scale, res = compress_with_feedback(gl, torch.zeros(gl.shape, device=gl.device))
        ratios[k] = res.abs().max() / scale
    compress_ms = (now() - t0) * 1e3
    ratios = {k: float(r) for k, r in ratios.items()}
    if max(ratios.values()) > 0.5 + COMPRESS_SLACK:
        raise AssertionError(f"ckpt_drill: compress_with_feedback beyond scale/2: {ratios}")
    del g

    opt = adamw_init(params, oc)
    state = {"params": params, "opt": opt}
    ckpt_bytes = tree_bytes(tr.state_tree(params, opt))
    ckpt_bytes_params = tree_bytes(tr.state_tree(params, opt)["params"])
    ckpt_dir, free = ckpt_dir_with_room(2 * ckpt_bytes + (1 << 30))
    saves, writes, restores, loads, inits = [], [], [], [], []
    memory = {}

    def stage(name):
        memory[name] = host_memory()
        say("ckpt_stage", card, stage=name, seconds=time.perf_counter() - t_phase,
            host_memory_gib=memory[name])

    stage("start")
    try:
        # (1) the reference; the parameters after CKPT_STOP steps saved, their
        # write going on under the next steps (the checkpoint deleted after)
        step = tr.make_step(loss_fn, oc, TRAIN_WARMUP, CKPT_STEPS)
        ref_ck = AsyncCheckpointer(ckpt_dir / "reference")
        ref_losses, spans, overlap_write = [], [], []
        with timing(ck_mod, "save_checkpoint", overlap_write):
            for i in range(CKPT_STEPS):
                t0 = now()
                _, m = step(state, batches(i))
                ref_losses.append(float(m["loss"]))
                spans.append((t0, now()))
                if i + 1 == CKPT_STOP:
                    ref_ck.save(CKPT_STOP, {"params": tr.state_tree(params, opt)["params"]})
            ref_ck.wait()
        shutil.rmtree(ckpt_dir / "reference")
        del ref_ck, loss_fn, batches, step
        gc.collect()
        ref = tr.state_tree(params, opt)  # the reference's final state, on the card
        w0, w1 = overlap_write[0]
        overlapped = [i for i, (a, e) in enumerate(spans) if a < w1 and e > w0]
        warm = [i for i in range(1, CKPT_STEPS) if i not in overlapped]
        stage("reference")

        # (2) run A: a job that stops after CKPT_STOP steps, checkpointed there
        train_counters(zero=True)
        runs = {}
        for name, n_steps, fail in (("A", CKPT_STOP, ()), ("B", CKPT_STEPS, (CKPT_FAIL,))):
            _, p, lf, bf = fresh()
            with timing(tr, "host_copy", inits):
                run = tr.Supervised("lm", p, lf, bf, oc, warmup=TRAIN_WARMUP, total=CKPT_STEPS,
                                    ckpt_dir=str(ckpt_dir), ckpt_every=CKPT_STOP,
                                    inject_failures=fail, device=device,
                                    log=lambda line: print(line, flush=True))
            with contextlib.ExitStack() as stack:
                stack.enter_context(timing(run.sup.ckpt, "save", saves))
                stack.enter_context(timing(ck_mod, "save_checkpoint", writes))
                stack.enter_context(timing(failures, "restore_checkpoint", restores))
                stack.enter_context(timing(run, "load_", loads))
                last, _ = run.run(n_steps)
            sup = run.sup
            runs[name] = {"step": last, "retries": sup.retries, "restarts": sup.restarts,
                          "stragglers": len(sup.straggler.events), "losses": run.losses}
            for i, loss in run.losses:
                if loss != ref_losses[i]:
                    raise AssertionError(f"ckpt_drill run {name}: step {i}'s loss {loss} "
                                         f"against the reference's {ref_losses[i]}")
            if name == "B":
                live = run.tree()
            del run, sup, p, lf, bf
            gc.collect()  # the supervisor and its step refer to each other
            stage(f"run {name}")
        launches = train_counters()
        steps_run = len(runs["A"]["losses"]) + len(runs["B"]["losses"])
        want = (CKPT_STOP, 0, 0, list(range(CKPT_STOP)), CKPT_STEPS, 1, 1,
                [CKPT_STOP, CKPT_STOP, CKPT_FAIL, CKPT_FAIL + 1])
        got = (runs["A"]["step"], runs["A"]["retries"], runs["A"]["restarts"],
               [i for i, _ in runs["A"]["losses"]], runs["B"]["step"], runs["B"]["retries"],
               runs["B"]["restarts"], [i for i, _ in runs["B"]["losses"]])
        if got != want:
            raise AssertionError(f"ckpt_drill: (A step, retries, restarts, steps run; B ...) "
                                 f"{got}, want {want}")
        if device.type == "cuda":
            flash = {"flash_attention": 2 * n, "flash_attention_tc": 2 * n,
                     "flash_attention_bwd": n, "flash_attention_bwd_tc": n}
            if {k: launches[k] for k in flash} != {k: v * steps_run for k, v in flash.items()}:
                raise AssertionError(f"ckpt_drill: launches {launches}, want {flash} × "
                                     f"{steps_run} steps")

        # the final state, and the last checkpoint read back, bit-equal
        ref_flat, live_flat = _flatten(ref), _flatten(live)
        if [k for k, _ in live_flat] != [k for k, _ in ref_flat]:
            raise AssertionError("ckpt_drill: the state's keys differ from the reference's")
        differ = [k for (k, a), (_, r) in zip(live_flat, ref_flat)
                  if not torch.equal(bits(a), bits(r))]
        if differ:
            raise AssertionError(f"ckpt_drill: run B's final state differs from the "
                                 f"reference's in {differ}")
        del live, live_flat
        keys = set(json.loads((ckpt_dir / f"step_{CKPT_STEPS:08d}" / "manifest.json")
                              .read_text())["keys"])
        paths = {f"{top}/{p}" for top in ("params", "opt/m", "opt/v") for p in H2O_JAX_PATHS}
        if keys != paths | {"opt/step"}:
            raise AssertionError(f"ckpt_drill: manifest keys {sorted(keys)}")
        t0 = time.perf_counter()
        restored, at, _ = restore_checkpoint(ckpt_dir, tree_map(lambda t: t.new_empty(0)
                                                                .cpu(), ref))
        readback_s = time.perf_counter() - t0
        stage("read back")
        differ = [k for (k, r), (_, t) in zip(ref_flat, _flatten(restored))
                  if not torch.equal(bits(t.to(device)), bits(r))]
        if at != CKPT_STEPS or differ:
            raise AssertionError(f"ckpt_drill: step {at}'s checkpoint differs in {differ}")
        del restored
        gb = (ckpt_dir / f"step_{CKPT_STEPS:08d}" / "arrays.npz").stat().st_size / 1e9
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    step_ms = [(e - a) * 1e3 for a, e in spans]
    write_s = [e - a for a, e in writes]
    say("ckpt", card, gb_per_checkpoint=gb, state_gb=ckpt_bytes / 1e9,
        host_snapshot_s=[e - a for a, e in saves], write_s=write_s,
        write_gb_s=[gb / w for w in write_s], restore_s=[e - a for a, e in restores],
        load_to_card_s=max((e - a for a, e in loads), default=None),
        init_host_copy_s=[e - a for a, e in inits], readback_s=readback_s,
        overlap_write_s=w1 - w0, overlap_write_gb=ckpt_bytes_params / 1e9,
        host_memory_gib=memory,
        snapshot_note="each checkpointer's first save: its host buffers allocated")
    say("ckpt_drill", card, arch="h2o-danube-1.8b", reduced=reduced, steps=CKPT_STEPS,
        stop=CKPT_STOP, fail_at=CKPT_FAIL, reference_losses=ref_losses,
        runs={k: {**v, "losses": [x for _, x in v["losses"]]} for k, v in runs.items()},
        bit_equal=True, warm_step_ms=float(np.median([step_ms[i] for i in warm])),
        overlapped_step_ms={i: step_ms[i] for i in overlapped},
        reference_step_ms=step_ms, grad_ms=grad_ms, compress_ms=compress_ms,
        compress_max_residual_over_scale=max(ratios.values()), ckpt_dir=str(ckpt_dir.parent),
        free_gb_before=free / 1e9, launches=launches, seconds=time.perf_counter() - t_phase)
    return launches


def flash_bwd_order_cost(gen, device):
    """What the backward's fixed order of dQ adds costs, at h2o-danube's
    training shape: the built kernel timed in turns (ordered, unordered,
    unordered, ordered) against a build of the same source with
    ``FLASH_BWD_UNORDERED`` (no waits: every key tile adds onto a zeroed
    accumulator as it comes, FlashAttention-3's non-deterministic mode),
    whose gradients are first held row by row to the ordered ones."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fl

    lib = build.library_path("flash_attention_bwd")
    variant = lib.with_name(lib.stem + "-unordered.so")
    if not variant.exists():
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DFLASH_BWD_UNORDERED", "-o",
                        str(variant), str(build.CSRC_DIR / "flash_attention_bwd.cu")],
                       check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(variant)).flash_attention_bwd_launch
    fn.argtypes, fn.restype = fl._bwd_entry().argtypes, ctypes.c_int
    b, h, hkv, s, d, window = LM_TRAIN_BATCH, 32, 8, LM_TRAIN_SEQ, 80, 4096
    q, k, v, do = (torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
                   for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d)))
    scale = d**-0.5
    out, lse = fl.flash_attention(q, k, v, True, window, scale, return_lse=True,
                                  round_scores=True)
    args = (q, k, v, out, lse, do, True, window, scale, True)

    def ordered():
        return fl.flash_attention_bwd(*args)

    def unordered():
        saved = fl._bwd_entry
        fl._bwd_entry = lambda: fn
        try:
            return fl.flash_attention_bwd(*args)
        finally:
            fl._bwd_entry = saved

    for name, g_, w_ in zip(("dq", "dk", "dv"), unordered(), ordered()):
        flash_row_check(g_, w_, f"unordered bwd {name}")
    times = [cuda_ms(fn_, reps=10) for fn_ in (ordered, unordered, unordered, ordered)]
    return {"shape": f"q bf16[{b},{h},{s},{d}], kv [{b},{hkv},{s},{d}], causal",
            "ordered_ms": [times[0], times[3]], "unordered_ms": [times[1], times[2]],
            "order_cost": (times[0] + times[3]) / (times[1] + times[2]) - 1}


def flash_bwd_row(b, h, hkv, s, d, window, n_launches, what, gen, device):
    """``flash_attention_bwd`` at q bf16 ``[b, h, s, d]``, kv ``[b, hkv, s,
    d]``, causal, scores rounded as the model rounds them: held row by row
    to its plain version on the same inputs and bit-equal when run twice,
    then timed beside
    its bound (the kept pairs × 10·D flops at the bf16 tensor-core rate),
    the plain version and SDPA's backward (FLASH backend, ``is_causal``,
    kv expanded to ``h`` heads: no window, so where a window binds it
    computes more pairs than the kernel)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as fl

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)

    scale = d**-0.5
    q, k, v = rnd((b, h, s, d)), rnd((b, hkv, s, d)), rnd((b, hkv, s, d))
    out, lse = fl.flash_attention(q, k, v, True, window, scale, return_lse=True,
                                  round_scores=True)
    lse_unchanged(out, fl.flash_attention(q, k, v, True, window, scale, round_scores=True),
                  what)
    do = rnd((b, h, s, d))
    args = (q, k, v, out, lse, do, True, window, scale, True)
    got = fl.flash_attention_bwd(*args)
    again = fl.flash_attention_bwd(*args)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"flash backward at {what}: two runs differ")
    del again
    want = fl.flash_attention_bwd_plain(*args)
    err = max(float((g_.float() - w_.float()).abs().max()) for g_, w_ in zip(got, want))
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        flash_row_check(g_, w_, f"bwd {name} at {what}")
    ratio = max(grad_row_ratio(g_, w_) for g_, w_ in zip(got, want))
    del got, want
    pairs = sum(min(i + 1, window or s) for i in range(s))
    nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4  # q, o, dO, dq; k, v, dk, dv
    f_bound, f_by = bound(nbytes, pairs * b * h * 10 * d, BF16_TENSOR_OPS_PER_S)
    ms = cuda_ms(lambda: fl.flash_attention_bwd(*args), reps=10)
    plain_ms = cuda_ms(lambda: fl.flash_attention_bwd_plain(*args), reps=1)
    kx, vx = (t.repeat_interleave(h // hkv, 1).requires_grad_(True) for t in (k, v))
    ql = q.detach().requires_grad_(True)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION), torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(ql, kx, vx, is_causal=True, scale=scale)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kx, vx), do,
                                                 retain_graph=True), reps=10)
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/transformer/attention.py:188",
        "launches": n_launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": f_bound,
        "bound_by": f_by, "library_ms": lib_ms,
        "library": f"scaled_dot_product_attention backward (FLASH backend, is_causal, "
                   f"kv expanded to {h} heads, no window)",
        "shape": f"q bf16[{b},{h},{s},{d}], kv [{b},{hkv},{s},{d}], causal, window "
                 f"{window} ({what})",
        "kernel_route": ("tc (TMA + wgmma, one pass)" if fl.bwd_route(torch.bfloat16, d)
                         == "tc" else "simt"),
        "max_row_ratio": ratio,
        "tflops": pairs * b * h * 10 * d / ms / 1e9, "bound_share": f_bound / ms,
    }


def train_kernel_rows(launches, seed, device):
    """The backward kernels timed at the training path's shapes, each
    against its plain twin, its bound and its library call:
    ``flash_attention_bwd`` at h2o-danube's layer shape and at
    deepseek-moe's D = 128 (:func:`flash_bwd_row`); the composed backwards (a sort, then
    ``gather_rows`` and ``segment_reduce``): the bag's at AutoInt's
    ``train_batch`` lookup (a dense 39 M-row gradient), the gather's and
    the segment sum's at gat-cora's ``x[src]`` read (library:
    ``index_add_`` / ``index_select``). Bytes count each input read once
    and each output written once."""
    from repro_torch import configs
    from repro_torch.data import gnn_full_batch, recsys_batches
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.kernels import autograd as kg

    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=device, dtype=dt)

    rows = [flash_bwd_row(LM_TRAIN_BATCH, 32, 8, LM_TRAIN_SEQ, 80, 4096,
                          launches["h2o-danube-1.8b"]["flash_attention_bwd"],
                          "h2o-danube-1.8b's training shape", gen, device),
            flash_bwd_row(LM_TRAIN_BATCH, 16, 16, LM_TRAIN_SEQ, 128, None, 0,
                          "deepseek-moe-16b's attention at 4,096 tokens (not on the "
                          "path: it trains on the CPU only)", gen, device)]

    def hold_scatter(fn, g, rows, n, what):
        """``fn(g)``, a gradient summed by ``rows`` into ``n`` rows, held to
        its float64 sum on the card: within ``TOL`` · Σ|x| for the row's
        random ``g``, exact for k/16 values of its shape."""
        for exact in (False, True):
            g_ = (torch.randint(-16, 17, g.shape, generator=gen, device=device).float() / 16
                  if exact else g)
            want, mag = host_scatter(g_, rows, n, device)
            hold_sum(fn(g_), want, mag, exact,
                     f"{what}, {'k/16' if exact else 'random'} values")
            del want, mag, g_

    def composed_row(name, fn, plain, library, nbytes, replaces, n_launches, shape, lib_name):
        got = fn()
        with plain_kernels():
            want = plain()
        t_bound, t_by = bound(nbytes, 0)
        ms = cuda_ms(fn, reps=5)
        return {
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/autograd.py",
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": float((got.float() - want.float()).abs().max()), "ms": ms,
            "plain_ms": cuda_ms(lambda: _plain_call(plain), reps=2), "bound_ms": t_bound,
            "bound_by": t_by, "library_ms": cuda_ms(library, reps=5), "library": lib_name,
            "shape": shape, "bound_share": t_bound / ms,
            "composed_of": "torch.sort of the int32 ids, csrc/gather_rows.cu, "
                           "csrc/segment_reduce.cu" if name != "segment_reduce_bwd"
                           else "csrc/gather_rows.cu",
        }

    spec = configs.get_spec("autoint")
    cfg = spec.config
    fields = next(recsys_batches(spec.shapes["train_batch"]["batch"], cfg.n_fields,
                                 cfg.vocab_per_field, seed=seed, device=device))["fields"]
    vrows = cfg.n_fields * cfg.vocab_per_field
    idx = (fields + torch.arange(cfg.n_fields, dtype=torch.int32, device=device)
           * cfg.vocab_per_field).reshape(-1, 1).contiguous()
    table = torch.empty((vrows, cfg.embed_dim), device=device)
    g = rnd((idx.shape[0], cfg.embed_dim))
    flat = idx.reshape(-1).long()
    hold_scatter(lambda g_: kg.embedding_bag_backward(g_, table, idx, None)[0], g, flat,
                 vrows, "embedding_bag backward at AutoInt's train_batch")
    rows.append(composed_row(
        "embedding_bag_bwd", lambda: kg.embedding_bag_backward(g, table, idx, None)[0],
        lambda: kg.embedding_bag_backward(g, table, idx, None)[0],
        lambda: torch.zeros_like(table).index_add_(0, flat, g),
        (g.numel() + idx.numel() + table.numel()) * 4,
        "src/repro/kernels/embedding_bag/kernel.py:42",
        launches["autoint"]["embedding_bag_backward"],
        f"d_table f32[{vrows},{cfg.embed_dim}] from {idx.shape[0]} one-slot bags "
        "(AutoInt train_batch lookup)", "zeros + index_add_"))
    del table, g, flat, idx, fields

    gcfg = configs.resolve_gnn_config(configs.get_spec("gat-cora").config, "full_graph_sm",
                                      configs.get_spec("gat-cora").shapes["full_graph_sm"])
    batch = gnn_full_batch(16 * GAT_TRAIN_BATCH, 6.0, gcfg.d_in, gcfg.n_out, seed=seed,
                           device=device)
    n, src, dst = batch["x"].shape[0], batch["src"], batch["dst"]
    width = gcfg.n_heads * gcfg.d_hidden
    g = rnd((src.shape[0], gcfg.n_heads, gcfg.d_hidden))
    src_l = src.long().clamp(0, n - 1)
    hold_scatter(lambda g_: kg.gather_rows_backward(g_, src, n, None), g, src_l, n,
                 "gather_rows backward at gat-cora's h[src]")
    rows.append(composed_row(
        "gather_rows_bwd", lambda: kg.gather_rows_backward(g, src, n, None),
        lambda: kg.gather_rows_backward(g, src, n, None),
        lambda: torch.zeros((n, gcfg.n_heads, gcfg.d_hidden), device=device).index_add_(
            0, src_l, g),
        (g.numel() + src.numel() + n * width) * 4,
        "src/repro/kernels/gather_rows/kernel.py:20",
        launches["gat-cora"]["gather_rows_backward"],
        f"d_h f32[{n},{gcfg.n_heads},{gcfg.d_hidden}] from {src.shape[0]} rows "
        "(gat-cora's h[src], Cora shape)", "zeros + index_add_"))
    go = rnd((n, gcfg.n_heads, gcfg.d_hidden))
    vals = rnd((src.shape[0], gcfg.n_heads, gcfg.d_hidden))
    dst_l = dst.long().clamp(0, n - 1)
    offsets = segment_offsets(dst, n)
    # the sum's backward is a gather: exactly the cotangent of each kept row
    keep = ((dst >= 0) & (dst < n) & batch["emask"]).reshape(-1, 1, 1)
    hold_sum(kg.segment_reduce_backward(go, vals, go, dst, n, "sum", batch["emask"], offsets),
             torch.where(keep, go.index_select(0, dst_l), 0.0).double(), None, True,
             "segment sum backward at gat-cora's aggregation")
    del keep
    rows.append(composed_row(
        "segment_reduce_bwd",
        lambda: kg.segment_reduce_backward(go, vals, go, dst, n, "sum", batch["emask"],
                                           offsets),
        lambda: kg.segment_reduce_backward(go, vals, go, dst, n, "sum", batch["emask"],
                                           offsets),
        lambda: go.index_select(0, dst_l),
        (go.numel() + dst.numel() + vals.numel()) * 4 + batch["emask"].numel(),
        "src/repro/kernels/segment_reduce/kernel.py:55",
        launches["gat-cora"]["segment_reduce_backward"],
        f"d_vals f32[{src.shape[0]},{gcfg.n_heads},{gcfg.d_hidden}] from {n} segments "
        "(gat-cora's aggregation, a sum)", "index_select"))
    return rows


def _plain_call(fn):
    with plain_kernels():
        return fn()


def main() -> int:
    scale, edgefactor, seed = 22, 16.0, 0  # Graph500 R-MAT at scale 22
    lm_batch, prompt_len, decode_steps = 4, 6144, 32
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import build  # fails beside no checkout: no result

    from repro_torch import configs

    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    # serving runs without gradients; the training phase turns them on per step
    torch.set_grad_enabled(False)
    # f32 results are compared with f32/f64 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--kernel-shapes" in sys.argv[1:]:
        return kernel_shapes_only(scale, edgefactor, seed, card)
    if "--bag-shapes" in sys.argv[1:]:
        return bag_shapes_only(seed, card)
    t0 = time.perf_counter()
    reports = build.build()
    say("build", card, seconds=time.perf_counter() - t0, built=sorted(reports))
    for name, log in reports.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", log)]
        say(
            "ptxas", card, kernel=name, instantiations=len(regs),
            max_registers=max(regs, default=0), spill_store_bytes=sum(spills),
            **({"per_entry": ptxas_entries(log)}
               if name in ("flash_attention", "flash_attention_bwd") else {}),
        )
        if "setmaxnreg ignored" in log:
            raise AssertionError(f"{name}: ptxas ignored setmaxnreg")
        if "Performance Loss" in log:  # e.g. C7514: every wgmma serialized
            raise AssertionError(f"{name}: ptxas serialized wgmma:\n" + "\n".join(
                line for line in log.splitlines() if "Performance Loss" in line))

    gen = torch.Generator().manual_seed(seed)
    say("tc_probe", card, ok=True, cases=len(TC_PROBE_CASES),
        max_rel_err=tc_probe(gen))
    if "--probe" in sys.argv[1:]:  # the first call on a new kernel: stop here
        return 0
    if "--moe-only" in sys.argv[1:]:  # a rehearsal of the MoE phase: no result line
        moe_path(configs.get_spec("deepseek-moe-16b").config, lm_batch, prompt_len,
                 decode_steps, seed, device, card)
        return 0
    if "--gnn-only" in sys.argv[1:]:  # a rehearsal of the GNN phase: no result line
        say("kernel_check", card, ok=True, cases=check_wide_routes(device, gen),
            versus="plain PyTorch versions")
        _, routes, _ = gnn_path(device, card)
        say("gnn_routes", card, **routes)
        return 0
    if "--flash-bwd" in sys.argv[1:]:  # the flash backward alone: no result line
        cases, ratio = check_backward_kernels(device, gen, flash_only=True)
        say("backward_check", card, ok=True, cases=cases, flash_bwd_max_row_ratio=ratio,
            versus="plain PyTorch versions")
        bwd_gen = torch.Generator(device=device).manual_seed(seed)
        for args in ((32, 8, 80, 4096, "h2o-danube-1.8b's training shape"),
                     (16, 16, 128, None, "deepseek-moe-16b's attention at 4,096 tokens")):
            h, hkv, d, window, what = args
            say("train_kernel", card, **flash_bwd_row(LM_TRAIN_BATCH, h, hkv, LM_TRAIN_SEQ,
                                                      d, window, 0, what, bwd_gen, device))
        say("flash_bwd_order", card, **flash_bwd_order_cost(bwd_gen, device))
        return 0
    if "--ckpt-drill" in sys.argv[1:]:  # the checkpoint drill alone: no result line
        ckpt_drill(seed, device, card)
        return 0
    if "--train-only" in sys.argv[1:]:  # a rehearsal of the training phase: no result line
        cases, ratio = check_backward_kernels(device, gen)
        say("backward_check", card, ok=True, cases=cases, flash_bwd_max_row_ratio=ratio,
            versus="plain PyTorch versions")
        launches = train_path(minibatch_graph(device, card, seed), seed, device, card)
        for row in train_kernel_rows(launches, seed, device):
            say("train_kernel", card, **row)
        return 0
    cases, row_ratio = check_kernels(device, gen)
    say("kernel_check", card, ok=True, cases=cases, flash_max_row_ratio=row_ratio,
        versus="plain PyTorch versions")

    launches, graphs, replicated = main_path(scale, edgefactor, seed, device, card)
    partitioned = partitioned_path(graphs, replicated, device, card)
    rows = kernel_rows(graphs, launches, partitioned)
    busy_share(graphs[0], replicated[2]["result"].supersteps, card)
    say("memory", card, path="graph",
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del graphs, replicated

    if "--graph-only" in sys.argv[1:]:  # a rehearsal of the graph kernels: stop here
        return finish(rows, card, t_start)
    torch.cuda.empty_cache()
    gnn_launches, routes, minibatch = gnn_path(device, card)
    minibatch = park(minibatch, torch.device("cpu"))
    for row in rows:  # the GNN phase's launches and wide-route times
        row["launches_gnn"] = {k[len(row["name"]) + 1:] or "all": v
                               for k, v in gnn_launches.items() if k.startswith(row["name"])}
        row["gnn_routes"] = {k: v for k, v in routes.items() if v["kernel"] == row["name"]}
    say("memory", card, path="gnn", allocated_after_gb=torch.cuda.memory_allocated() / 1e9)
    lm = lm_path(configs.get_spec("h2o-danube-1.8b").config, lm_batch, prompt_len,
                 decode_steps, seed, device, card)
    torch.cuda.empty_cache()
    rows += moe_path(configs.get_spec("deepseek-moe-16b").config, lm_batch, prompt_len,
                     decode_steps, seed, device, card)
    torch.cuda.empty_cache()
    spec = configs.get_spec("autoint")
    rec = autoint_path(spec.config, spec.shapes, seed, device, card)
    rows += model_kernel_rows(lm, rec)
    del rec
    torch.cuda.empty_cache()
    cases, ratio = check_backward_kernels(device, gen)
    say("backward_check", card, ok=True, cases=cases, flash_bwd_max_row_ratio=ratio,
        versus="plain PyTorch versions")
    launches = train_path(park(minibatch, device), seed, device, card)
    del minibatch
    torch.cuda.empty_cache()
    drill = ckpt_drill(seed, device, card)
    torch.cuda.empty_cache()
    rows += train_kernel_rows(launches, seed, device)
    for name in ("flash_attention", "flash_attention_bwd"):  # the drill's launches
        row = next(r for r in rows if r["name"] == name and "path" not in r)
        row["launches_ckpt_drill"] = drill[name]
    return finish(rows, card, t_start)


def kernel_shapes_only(scale, edgefactor, seed, card) -> int:
    """``--kernel-shapes``: builds the two graph kernels, times them over
    :func:`graph_kernel_shapes` on the main path's symmetric R-MAT and
    stops, printing no result line. It uses only the wrappers' public
    calls, so a copy of this script beside an earlier tree of the port
    times that tree's kernels."""
    from repro_torch.graph import generators as G
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["gather_rows", "segment_reduce"])
    sym = G.rmat(scale, edgefactor, directed=False, seed=seed, device="cuda")
    table = torch.randperm(sym.n_vertices, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed))
    say("kernel_shapes", card, setup_s=time.perf_counter() - t0,
        **graph_kernel_shapes(sym, table.to(torch.int32)))
    return 0


def bag_shapes_only(seed, card) -> int:
    """``--bag-shapes``: builds ``embedding_bag`` alone and times it beside
    ``F.embedding_bag`` over four shapes: ``serve_bulk``'s lookup (AutoInt's
    flat table from the seed, the Zipf ids of ``recsys_batches`` as
    :func:`autoint_path` draws them), uniform ids over all 39 M rows (the
    rows from device memory), ``arange`` ids (rows in order), and a
    multi-hot f32 ``[10⁶, 64]`` table with 65,536 bags of 8 weighted slots.
    Each beside its bound by distinct rows (:func:`bag_bytes`); prints no
    result line. It uses only the wrappers' public calls, so a copy of this
    script beside an earlier tree of the port times that tree's kernel."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.data import recsys_batches
    from repro_torch.kernels import build, embedding_bag, embedding_bag_plain
    from repro_torch.models.recsys import autoint as ai

    t0 = time.perf_counter()
    build.build(["embedding_bag"])
    spec = configs.get_spec("autoint")
    tables = ai.init(spec.config, seed=seed, device="cuda")["tables"]
    f, v, d = tables.shape
    table = tables.reshape(f * v, d)
    fields = next(recsys_batches(spec.shapes["serve_bulk"]["batch"], f, v,
                                 seed=seed + 1, device="cuda"))["fields"]
    n = fields.numel()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    offsets = torch.arange(f, dtype=torch.int32, device="cuda") * v
    multi_table = torch.randn((10**6, 64), generator=gen, device="cuda")
    shapes = {
        "serve_bulk": (table, (fields + offsets).reshape(-1, 1), None),
        "uniform_39M": (table, torch.randint(0, f * v, (n, 1), generator=gen, device="cuda",
                                             dtype=torch.int32), None),
        "arange": (table, torch.arange(n, dtype=torch.int32, device="cuda").reshape(-1, 1),
                   None),
        "multi_hot_8": (multi_table,
                        torch.randint(0, 10**6, (65536, 8), generator=gen, device="cuda",
                                      dtype=torch.int32),
                        torch.randn((65536, 8), generator=gen, device="cuda")),
    }
    sync(torch.device("cuda"))
    out = {}
    for name, (tab, idx, w) in shapes.items():
        got = embedding_bag(tab, idx, w)
        want = embedding_bag_plain(tab, idx, w)
        if w is None and not torch.equal(got, want):
            raise AssertionError(f"embedding_bag disagrees with its plain version: {name}")
        torch.testing.assert_close(got, want, rtol=TOL[tab.dtype], atol=TOL[tab.dtype])
        distinct, nbytes = bag_bytes(tab, idx, w is not None)
        out[name] = {
            **timed(lambda: embedding_bag(tab, idx, w),
                    (bound(nbytes, idx.numel() * tab.shape[1])[0], nbytes)),
            "distinct_rows": distinct, "bags": idx.shape[0], "slots": idx.shape[1],
            "library_ms": cuda_ms(lambda: F.embedding_bag(idx, tab, mode="sum",
                                                          per_sample_weights=w)),
        }
        del got, want
    say("bag_shapes", card, setup_s=time.perf_counter() - t0, **out)
    return 0


def finish(rows, card, t_start) -> int:
    """The kernel table, the card, and the result line."""
    say("total", card, seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
