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
width, then a restart-and-replay drill of the h2o-danube trainer, and the
models on a mesh of gloo ranks sharing the card (three GNNs, the MoE
expert-parallel, the trainers sharded, h2o-danube-1.8b tensor-parallel).
What it does, in order, and fails on the first thing that is wrong:

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
   host sum; segment sum, max and min (planted ties) bit-equal to the CPU's;
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
   version and bit-equal when run twice), the gather's and the bag's table
   gradients (``csrc/scatter_rows.cu``) and the segment sum's backward
   (``csrc/segment_reduce_bwd.cu``) against theirs and
   ``index_add_``/``index_select``, beside their CUDA-graph device times,
   the sort's share and the composition PR 16 had, timed in the same run,
   plus a hub run of ``HUB_IDS`` and segment max/min with ties and a mask
   (``--train-only`` runs the build, the probe and this phase alone, and
   prints no result line; ``--flash-bwd`` runs the build, the probe, the
   flash backward's sweep and its two rows, then times what the fixed
   order of its dQ adds costs against a build without it
   (``FLASH_BWD_UNORDERED``), and prints no result line).
8. drills the supervised trainer (``ckpt_drill``): h2o-danube-1.8b at full
   width as in 7, ``DRILL_LAYERS`` deep, ``CKPT_STEPS`` plain steps as the reference
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
9. runs the models on the mesh (``mesh_gnn``, ``mesh_moe``,
   ``mesh_train``): gloo ranks on the one card (NCCL refuses two ranks on
   a device), their inputs the parent's by CUDA IPC — correctness runs,
   not multi-card times. pna, gat-cora and graphcast (the GNN phase's
   graphs, weights and one-rank outputs) on ``("data", "model") = (2,
   2)``, each rank holding only its block of the graph's nodes and edges
   (views of the parent's tensors) and of every activation between
   layers: each rank's rows of the output held to the same rows of the
   one-rank forward by ``gnn_serve``'s rule (``GNN_TOL`` · max|out|;
   graphcast element by element), PNA on its fused branch (three
   reduce-scatters a layer), every rank's launches per route equal to the
   one-rank forward's, its batch and activation bytes beside the whole
   ones and its peak beside the one-rank forward's;
   deepseek-moe-16b at full width cut to ``MESH_MOE_LAYERS`` layers
   (views of phase 4b's weights), tensor- and expert-parallel on (1, 4)
   (``mesh_moe``: 4 of 16 heads, 16 of 64 experts and 6,176 / 4 cache
   slots a rank): phase 4b's prompts, then the one-rank serve's tokens at
   that depth fed step by step, each step's logits within
   ``MESH_LOGIT_TOL`` · max|logit| of the one-rank serve's (the prefill's
   error reported apart), the greedy tokens equal past that margin, every
   rank's launches the one-rank serve's (each flash launch on ``H/4``
   heads); (a) ``moe_ffn_ep`` on layer 0's gathered input bit-equal to
   ``moe_ffn_local`` with the whole experts, slots and drops included; (b)
   every layer routed alike on every model rank; the dropped share beside
   one rank's; rank 0's prefill and decode step dry-run against the card
   (``dryrun_vs_card``); gat-cora's
   ``launch.train.Supervised`` on 2 ranks (its ``(2, 1)`` mesh, each rank
   on its half of the graph) against one rank: ``TRAIN_STEPS`` losses and
   the final parameters within ``TRAIN_TOL``, each rank's launches,
   backwards included, equal, its last step dry-run against the card
   (``dryrun_vs_card``);
   and the sharded trainer (``Supervised.run``: ``MESH_TRAIN_STEPS`` steps
   and the checkpoint at the end, the shards gathered into rank 0's host
   buffers) on gloo ranks against one rank: AutoInt at full width on 2
   ranks (``train_batch``'s 65,536 rows, 32,768 a rank, the tables whole),
   and h2o-danube-1.8b at full width cut to ``CKPT_LAYERS`` layers (4 ×
   4,096 tokens) on ``(data, model) = (2, 1)`` (each rank holding its FSDP
   shards of the state) and tensor- and sequence-parallel on (1, 2) and
   (2, 2) (its FSDP and model shards): the losses and the parameters'
   relative global distance within ``TRAIN_TOL``, each rank's launches per
   route equal to one rank's, every flash forward on ``H/m`` heads where
   one rank's has ``H``, the live state's bytes a rank beside the whole
   state's, the peak a rank beside one rank's, the collective bytes and
   gloo walls; each h2o rank step (the run's last, measured) dry-run (rank
   0 of a fake group on the same mesh) against the real rank's
   (``dryrun_vs_card``: launches equal, peak within ``DRY_PEAK_TOL``); and
   h2o's serve tensor-parallel on (1, 2) (``mesh_tp``): 4 × 6,144 prompt
   tokens and ``MESH_TP_DECODE_STEPS`` teacher-forced decode steps, each
   step's logits within ``MESH_LOGIT_TOL`` · max|logit|, the cache ``C/2``
   slots a rank
   (``--mesh-only`` runs the build and this phase alone, its one-rank
   references included, and prints no result line; ``--mesh-tp`` h2o's
   part alone; ``--mesh-moe`` the MoE part alone; ``--mesh-tp-probe``
   h2o's tensor-parallel serve against one rank in float32 and bfloat16,
   at one layer and six, and ``--mesh-moe-probe`` the MoE serve's alike,
   and print no result line; ``--mesh-probe``
   compares graphcast on the mesh with one rank layer by layer, in bf16
   and in f32, and prints no result line).
10. runs the four ``examples/torch_*.py`` on the card through the
   functions they expose, each one's assertions held (``example`` lines),
   then the dry-run phase: ``flash_attention``'s Python route rule (which
   the kernels' fake route takes) against the built libraries' own for
   every D of 1..128 in f32 and bf16, and every cell of
   ``DRY_FULL_ARCHS`` dry-run at full width on fake CUDA tensors
   (``dryrun_cell`` lines: fits against the card's memory, peak GB,
   bottleneck), and those of ``DRY_POD_ARCHS`` and the cells of
   ``DRY_POD_CELLS`` (GraphCast on ogb_products, which must fit) as rank 0
   of the JAX package's 256- and 512-rank meshes (a fake process group:
   the rank's shards and rows; its peak and collective GB). Throughout the run, each step that a phase also runs for
   real — the h2o-danube and deepseek-moe prefill and decode step, the
   four GNN forwards and the minibatch, AutoInt's three serve shapes, the
   four training steps — is dry-run at that phase's shapes and run twice
   more (:func:`dry_vs_card`): its launches per route must equal the
   card's, its predicted peak be within ``DRY_PEAK_TOL`` of the card's,
   and a ``dryrun_vs_card`` line prints both beside the predicted step
   lower bound, the warm time and ``mfu`` (``--dryrun-only`` runs the
   build, the examples, the h2o-danube serve, a gat-cora forward, AutoInt's
   serve, three trainers and the dry-run phase, and prints no result line).

Each path's launch counters are set to 0 just before it is driven and read
just after. Every number is printed beside the card's name and power
limit. The line before the last is the kernel table as JSON; the last line
is ``{"ok": true, "device": {...}}``. Without a card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
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


def main_graphs(scale, edgefactor, seed, device, card):
    """The main path's graphs: the symmetric and the directed weighted
    R-MAT of ``scale`` (a ``graphs`` line)."""
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
    return sym, dirw


def main_path(scale, edgefactor, seed, device, card, graphs=None):
    """Build the graphs (unless given: :func:`main_graphs`'), then run the
    programs with the launch counters zeroed just before and read just
    after."""
    from repro_torch.core import algorithms as alg

    sym, dirw = graphs or main_graphs(scale, edgefactor, seed, device, card)

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


def run_ranks(shared, device, target=None, world=RANKS, what="partitioned"):
    """Spawns ``world`` gloo ranks of ``target`` (:func:`partition_rank`
    unless told) on ``device``, each handed ``shared`` (its tensors on the
    card by CUDA IPC), and collects their reports; any rank's failure fails
    the phase, and every rank is stopped."""
    import queue as queue_mod
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target or partition_rank,
                         args=(r, port, device, list(shared), queue))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    reports = {}
    try:
        deadline = time.perf_counter() + 600
        while len(reports) < world:
            try:
                rank, rep = queue.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise AssertionError(f"{what} ranks: exit codes {dead} or timed out")
                continue
            if "error" in rep:
                raise AssertionError(f"{what} rank {rank} failed:\n{rep['error']}")
            reports[rank] = rep
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{what} ranks exited {codes}")
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
    reports, ranks_s = run_ranks([pgs, jobs], device)
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
    """The graph kernels' wrappers pointed at their plain versions (the
    module attributes ``graph.ops`` and ``kernels.autograd`` call): the two
    forward kernels and their backwards ``scatter_rows`` and
    ``segment_reduce_bwd``, restored on the way out."""
    from repro_torch.kernels.gather_rows import ops as g
    from repro_torch.kernels.scatter_rows import ops as c
    from repro_torch.kernels.segment_reduce import ops as s

    saved = g.gather_rows, s.segment_reduce, c.scatter_rows, s.segment_reduce_bwd
    g.gather_rows, s.segment_reduce = g.gather_rows_plain, s.segment_reduce_plain
    c.scatter_rows, s.segment_reduce_bwd = c.scatter_rows_plain, s.segment_reduce_bwd_plain
    try:
        yield
    finally:
        g.gather_rows, s.segment_reduce, c.scatter_rows, s.segment_reduce_bwd = saved


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


def gnn_check(arch, got, want, tol, whole=None):
    """``got`` against ``want`` by ``arch``'s rule (``GNN_ELEMENTWISE``: each
    element within ``tol``·|want| + ``tol``·median|want|; else max|Δ| within
    ``tol``·max|want|): (max|Δ|, max|want|, the rule, the share of elements
    past it). ``want`` may be a block of rows of ``whole``, the output the
    rule's max and median are taken over."""
    diff, mag = (got.float() - want.float()).abs(), want.float().abs()
    ref = mag if whole is None else whole.float().abs()
    err, scale = float(diff.max()), float(ref.max())
    if arch in GNN_ELEMENTWISE:
        check = f"|Δ| ≤ {tol}·|ref| + {tol}·median|ref| per element"
        limit = tol * mag + tol * float(ref.median())
    else:
        check = f"max|Δ| ≤ {tol}·max|out|"
        limit = tol * scale
    return err, scale, check, float((diff > limit).float().mean())


def gnn_serve(arch, cfg, batch, seed, device, card, keep=None):
    """``models.gnn.models.forward`` of ``cfg`` (weights from ``init(seed)``)
    on a full-graph batch: the first forward with the launch counters
    zeroed before and read after, three warm ones and one under the
    profiler (the card's busy share), then the same forward with the two
    graph kernels' wrappers pointed at their plain versions, held to
    ``GNN_TOL``. Returns the launches of one forward; into ``keep`` (a
    dict) go the weights, the output and the warm ms, for the mesh phase."""
    from repro_torch.launch import dryrun
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
    err, scale, check, past = gnn_check(arch, out, ref, GNN_TOL[cfg.compute_dtype])
    if past:
        raise AssertionError(f"{arch}: kernels against plain versions past {check} at a "
                             f"share {past} of the elements: max|Δ| {err}, max|out| {scale}")
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
    del ref
    dry_vs_card(f"{arch} forward", lambda p, b: gm.forward(p, b, cfg), (params, batch), device,
                card, dryrun.gnn_model_flops(cfg, n, e) / 3)
    if keep is not None:  # the output in host memory: kept on the card it splits the cache
        keep.update(params=params, want=out.cpu(), one_rank_ms=warm_s * 1e3,
                    one_rank_peak_gb=peak)
    del params, out
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
    from repro_torch.launch import dryrun
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
    dry_vs_card(f"{cfg.name} minibatch forward",
                lambda p, b: gm.sage_minibatch_forward(p, b, cfg), (params, first), device, card,
                dryrun.gnn_model_flops(cfg, *block_graph(batch_nodes, cfg.fanouts)) / 3)
    return launches, (ext, blocks[1].neighbors.reshape(-1))


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def gnn_path(device, card, shapes=None, degrees=None, n_batches=MINIBATCHES, seed=0,
             mesh=True, only_mesh=False):
    """Serve the four GNNs at their published widths (``configs/``, weights
    from ``init(seed)``): graphsage-reddit, gat-cora and pna on one
    ogb_products-shaped batch (``gnn_full_batch``: R-MAT at scale 22, about
    62 M symmetric edges, d_feat 100, 47 classes), graphcast (16 layers ×
    512, bf16) on the full_graph_sm shape, and sampled graphsage-reddit
    minibatches on a Reddit-sized R-MAT (scale 18, d_in 602, fanouts 25-10,
    1,024 seeds a batch). ``shapes`` / ``degrees`` override
    ``GNN_SHAPES`` / ``GNN_AVG_DEGREE`` for a rehearsal at a small size
    (``n_edges`` None skips the edge-count check). With ``mesh`` pna,
    gat-cora and graphcast then run on the (2, 2) mesh (:func:`mesh_gnn`)
    against these one-rank forwards; ``only_mesh`` serves just those three
    on one rank first (no routes, no minibatches). Returns this phase's
    launches of both graph kernels, on the card their wide routes' times at
    these shapes (:func:`gnn_route_rows`), the minibatch graph and the mesh
    ranks' launches."""
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
    mesh_models = []
    for arch in GNN_FULL:
        if only_mesh and arch not in MESH_GNN:
            continue
        cfg = cfg_for(arch, "ogb_products")
        kept = {} if mesh and arch in MESH_GNN else None
        per_model[arch] = gnn_serve(arch, cfg, batch, seed, device, card, keep=kept)
        add_launches(total, per_model[arch])
        if kept is not None:
            mesh_models.append(dict(arch=arch, cfg=cfg, batch=batch,
                                    launches=per_model[arch], **kept))
    routes = gnn_route_rows(batch, per_model) if device.type == "cuda" and not only_mesh \
        else {}
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
    kept = {} if mesh else None
    per_model["graphcast"] = gnn_serve("graphcast", cfg, batch, seed, device, card,
                                       keep=kept)
    add_launches(total, per_model["graphcast"])
    if kept is not None:
        mesh_models.append(dict(arch="graphcast", cfg=cfg, batch=batch,
                                launches=per_model["graphcast"], **kept))
    if device.type == "cuda" and not only_mesh:
        routes.update(gnn_route_rows(batch, per_model, graphcast=True))
    del batch, kept
    # the sampled phase's graph, a host build, is made while the mesh ranks
    # run (they wait on gloo's host copies)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = None if only_mesh else pool.submit(minibatch_graph, device, card, seed,
                                                     shapes, degrees)
        mesh_launches = mesh_gnn(mesh_models, device, card) if mesh else {}
        del mesh_models
        if only_mesh:
            return total, routes, None, mesh_launches
        minibatch = pending.result()

    # sampled GraphSAGE on a Reddit-sized graph
    cfg, graph, feats, labels, batch_nodes = minibatch
    per_model["graphsage-reddit minibatch"], hop1_read = minibatch_serve(
        cfg, graph, feats, labels, batch_nodes, n_batches, seed, device, card)
    add_launches(total, per_model["graphsage-reddit minibatch"])
    if device.type == "cuda":
        routes.update(gnn_route_rows(None, per_model, hop1_read=hop1_read))
    del graph, feats, labels, hop1_read
    say("launches", card, path="gnn", **total, per_model=per_model)
    say("gnn_phase", card, seconds=time.perf_counter() - t_phase, build_s=build_s)
    return total, routes, minibatch, mesh_launches


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
    flash_attention.launches_pos = 0
    res = srv.serve(params, cfg, prompts, steps)
    launches = flash_attention.launches
    launches_tc = flash_attention.launches_tc
    if device.type == "cuda" and not (launches == launches_tc == cfg.n_layers
                                      and flash_attention.launches_pos == 0):
        raise AssertionError(f"{launches} flash launches ({launches_tc} on the tensor "
                             f"cores, {flash_attention.launches_pos} on the positions "
                             f"route) for one prefill of {cfg.n_layers} layers")
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
    del ref, got_l, diff
    lm_dry_vs_card(params, cfg, prompts, res, prompt_len, steps, batch, device, card)
    del params
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
    for counter in ("launches", "launches_tc", "launches_simt", "launches_pos"):
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
        "flash_attention_simt": 0, "flash_attention_pos": 0,
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


def moe_path(cfg, batch, prompt_len, steps, seed, device, card, one_rank=None):
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
    rows at this path's shapes on the card, else ``[]``; into ``one_rank``
    (a dict) go the weights and the prompts, for the mesh phase."""
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
    lm_dry_vs_card(params, cfg, prompts, res, prompt_len, steps, batch, device, card)
    if one_rank is not None:
        one_rank.update(params=params, prompts=prompts)
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
    from repro_torch.launch import dryrun
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
    for name in ("serve_p99", "serve_bulk"):
        dry_vs_card(f"{cfg.name} {name}", lambda p, b: ai.forward(p, b, cfg),
                    (params, batches[name]), device, card,
                    dryrun.recsys_model_flops(cfg, shapes[name]))
    dry_vs_card(f"{cfg.name} retrieval_cand",
                lambda p, b: ai.retrieval_score(p, b, cfg, top_k=100), (params, retr), device,
                card, dryrun.recsys_model_flops(cfg, shapes["retrieval_cand"]))
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
    """Every kernel's launch counters per route, and the backwards' calls
    (``kernels.autograd``), set to 0 first with ``zero``."""
    from repro_torch.kernels import autograd as kg
    from repro_torch.kernels import embedding_bag, flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.scatter_rows import scatter_rows
    from repro_torch.kernels.segment_reduce import segment_reduce_bwd

    out = graph_counters(zero)
    names = {
        flash_attention: ("launches", "launches_tc", "launches_simt", "launches_pos"),
        flash_attention_bwd: ("launches", "launches_tc", "launches_simt", "launches_pos"),
        embedding_bag: ("launches", "launches_vec", "launches_scalar"),
        scatter_rows: ("launches",),
        segment_reduce_bwd: ("launches", "launches_sum", "launches_ties"),
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
    for op in ("sum", "max", "min"):
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
              lr=TRAIN_LR, model_flops=None):
    """``TRAIN_STEPS`` steps of ``launch.train.make_step`` (AdamW, the
    cosine schedule) on ``batches(i)``: (c) first step 0's loss and global
    gradient norm with the kernels against the same with every kernel's
    plain version (``TRAIN_TOL``); every step timed (host clock to the
    synchronised end); the launches per route of all the steps exactly
    ``want`` × steps; every loss finite, the last below the first, and
    the loss of step 0's batch after the steps below its loss before them
    (the batches differ from step to step, so the last step's loss alone
    says little); then one more step under the profiler. Prints a
    ``train`` line, then the dry-run of the step on ``batches(0)`` against
    two more (:func:`dry_vs_card`, with ``model_flops``)."""
    from repro_torch.launch import dryrun
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
    dry_vs_card(f"{name} train step",
                dryrun.train_step(loss_fn, oc, warmup=TRAIN_WARMUP, total=TRAIN_STEPS),
                (params, state["opt"], batches(0)), device, card, model_flops)
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
    reduced configs at small batches: a CPU rehearsal; ``minibatch`` None
    leaves graphsage-reddit out. Returns each model's launches."""
    from repro_torch import configs
    from repro_torch.data import gnn_full_batch, gnn_minibatches
    from repro_torch.launch import dryrun
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
        lr=LM_TRAIN_LR, model_flops=dryrun.lm_model_flops(cfg, lm_shape("train", lm_s, lm_b)))
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
    # segment reductions; its backward: 5 gather backwards (``scatter_rows``
    # each), 2 segment-sum backwards and the softmax's max backward
    # (``segment_reduce_bwd`` each: ``sum``, ``ties``)
    n_gather, n_segment = 5 * layers, 3 * layers
    out["gat-cora"] = train_run(
        "gat-cora", cfg.compute_dtype, params, loss_fn, batches, batches(0)["x"].shape[0],
        "nodes", {"gather_rows": n_gather, "gather_rows_scalar": n_gather,
                  "segment_reduce": n_segment, "segment_reduce_cols": n_segment,
                  "scatter_rows": 5 * cfg.n_layers,
                  "segment_reduce_bwd": 3 * cfg.n_layers,
                  "segment_reduce_bwd_sum": 2 * cfg.n_layers,
                  "segment_reduce_bwd_ties": cfg.n_layers,
                  "gather_rows_backward": 5 * cfg.n_layers,
                  "segment_reduce_backward": 3 * cfg.n_layers}, device, card,
        model_flops=dryrun.gnn_model_flops(cfg, fb["x"].shape[0], fb["src"].shape[0]))
    del params, fb

    if minibatch is not None:
        mcfg, graph, feats, labels, batch_nodes = minibatch
        params = common.trainable(gm.init(mcfg, seed, device))
        data = gnn_minibatches(graph, feats, labels, batch_nodes, mcfg.fanouts,
                               torch.Generator(device=device).manual_seed(seed))
        mbs = [next(data) for _ in range(TRAIN_STEPS + 1)]
        out["graphsage-reddit"] = train_run(
            "graphsage-reddit minibatch", mcfg.compute_dtype, params,
            lambda p, b: gm.sage_minibatch_loss(p, b, mcfg), lambda i: mbs[i], batch_nodes,
            "seeds", {}, device, card, model_flops=dryrun.gnn_model_flops(
                mcfg, *block_graph(batch_nodes, mcfg.fanouts)))
        del params, mbs, data

    _, cfg, params, loss_fn, batches = tr.build("autoint", reduced, 64 if reduced else 65_536,
                                                0, seed, device)
    out["autoint"] = train_run(
        "autoint", cfg.param_dtype, params, loss_fn, batches,
        batches(0)["fields"].shape[0], "rows",
        {"embedding_bag": 1, "embedding_bag_vec": 1, "scatter_rows": 1,
         "embedding_bag_backward": 1}, device, card,
        model_flops=dryrun.recsys_model_flops(cfg, {"kind": "train",
                                                    "batch": batches(0)["fields"].shape[0]}))
    del params, loss_fn, batches
    say("train_phase", card, seconds=time.perf_counter() - t_phase)
    return out


# -- 8. the checkpoint drill ---------------------------------------------------

#: the drill's schedule: the reference's steps; run A stops after
#: ``CKPT_STOP`` (a job cut short, its checkpoint written), run B resumes
#: there and fails once at step index ``CKPT_FAIL``
CKPT_STEPS, CKPT_STOP, CKPT_FAIL = 6, 3, 4
#: the drill's depth: h2o-danube-1.8b at full width, its 24 layers cut to 3
#: (6 until the dense LM's mesh cases came; 24 before the mesh phase) to
#: make room in the run's time for the mesh phase; what the drill checks
#: (bit-equal replay) does not depend on depth
DRILL_LAYERS = 3
#: the depth of h2o-danube-1.8b's mesh cases (its sharded and
#: tensor-parallel trainers and serve): full width, 2 of its 24 layers (6
#: until the GNN mesh phase's sharded graphs came, then 4 until the flash
#: positions phase came), to keep the run inside its time; what they check
#: (each mesh against one rank at the same depth, every layer the same
#: code, a layer's output feeding the next) does not depend on depth
CKPT_LAYERS = 2
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
    """Restart-and-replay drill of h2o-danube-1.8b at full width, ``DRILL_LAYERS``
    deep (bf16, remat, ``LM_TRAIN_BATCH`` × ``LM_TRAIN_SEQ`` tokens,
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
    from repro_torch import configs
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

    cut = None if reduced else dataclasses.replace(
        configs.get_spec("h2o-danube-1.8b").config, n_layers=DRILL_LAYERS)

    def fresh():
        return tr.build("h2o-danube-1.8b", reduced, b, s, seed, device, config=cut)[1:]

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


#: the positions route's full-width cases: left-padded prompts of these
#: lengths in POSITIONS_SLOTS slots (positions ``arange − pad``, the pads
#: masked out of the keys), at h2o-danube's and deepseek-moe's attention
POSITIONS_SLOTS = 6144
POSITIONS_LENGTHS = (6144, 4096, 1536, 64)
POSITIONS_SHAPES = (  # (arch, H, Hkv, D, causal, window)
    ("h2o-danube-1.8b", 32, 8, 80, True, 4096),
    ("deepseek-moe-16b", 16, 16, 128, True, None),
)
#: the SIMT case: [B, H, Hkv, Sq, Sk, D], random positions in [0, Sk + 100),
#: a window, 10 % of the keys masked, f32, JAX's chunk_kv (its pad > 0)
POSITIONS_SIMT = (2, 4, 2, 700, 900, 64, 128, 256)
#: a batch whose last row keeps no key at all (its mask all False), the
#: first left-padded: [B, H, Hkv, S, D], causal; bf16 on the tensor cores,
#: then f32 on the SIMT route (dead tiles and rows that keep no key there)
POSITIONS_EMPTY_ROW = (2, 8, 2, 1024, 128, 300)


def walk_counts(fwd_seen, bwd_seen, q_pos, k_pos, kv_mask, h, sq, sk, causal, window,
                route: str) -> dict:
    """The tiles the positions route's kernels visited in one forward and
    one backward, as the card reports them (``ops.visited``), held to the
    kernels' rule run on the host. Tensor cores: the walk lists the kernels
    followed (128 × 128 forward, 64 × 128 backward) must equal
    ``ops.walk_lists`` entry for entry — tile, the warpgroups' kinds
    (interior: mask-free) and the backward's dQ rank. SIMT (64 × 64 both):
    the tiles each kernel's blocks counted as they visited them must equal
    the heads times ``ops.live_tiles``' live tiles; the pairs then come
    from that walk. Returns live tiles a head beside every tile, and the
    (query, key) pairs a head visits in them (rows below Sq, keys below
    Sk)."""
    from repro_torch.kernels.flash_attention import ops as fl

    positions = tuple(t.cpu() for t in (q_pos, k_pos, kv_mask))
    b = q_pos.shape[0]

    def span(t, n, s_):
        return min(s_, (t + 1) * n) - t * n

    out = {}
    for what, seen in (("fwd", fwd_seen), ("bwd", bwd_seen)):
        if route == "tc":
            bq, bk = (128, 128) if what == "fwd" else (64, 128)
            want = fl.walk_lists(positions, sq, sk, causal, window, bwd=what == "bwd")
            got = None if seen is None else seen.get("walk")
            if got != want:
                at = next((i for i, (x, y) in enumerate(zip(got or [], want)) if x != y),
                          min(len(got or []), len(want)))
                raise AssertionError(
                    f"positions route {what}: the card's walk differs from the rule's at "
                    f"entry {at} of {len(want)}: {(got or [])[at:at + 1]} against "
                    f"{want[at:at + 1]}")
            tiles = ([(qt, kt) for _, qt, kt, *_ in seen["walk"]] if what == "fwd"
                     else [(qt, kt) for _, kt, qt, *_ in seen["walk"]])
            live, source = len(tiles), "the card's walk lists, equal to ops.walk_lists"
            interior = sum(kind == fl.TILE_INTERIOR for e in seen["walk"] for kind in e[3:5])
            extra = {"mask_free_halves": interior}
        else:
            bq = bk = 64
            walk = fl.live_tiles(sq, sk, causal, window, bq, bk, positions=positions)
            tiles = [(qt, kt) for _, qt, kts in walk for kt in kts]
            want = [h * len(tiles)] * (1 if what == "fwd" else 2)
            if seen is None or seen.get("tiles") != want:
                raise AssertionError(f"positions route {what}: the card's blocks visited "
                                     f"{seen} tiles, the rule leaves {want} live")
            live = seen["tiles"][0] // h
            source = "the card's tile counts (all heads), equal to ops.live_tiles' × H"
            extra = {"tiles_counted_on_card": seen["tiles"]}
        out[what] = {"tiles": f"{bq} x {bk}", "live_tiles": live,
                     "every_tile": b * -(-sq // bq) * -(-sk // bk),
                     "visited_pairs_per_head": sum(span(qt, bq, sq) * span(kt, bk, sk)
                                                   for qt, kt in tiles),
                     "tiles_from": source, **extra}
    return out


def kept_pairs_host(q_pos, k_pos, kv_mask, causal: bool, window) -> int:
    """The (query, key) pairs one head keeps, summed over the batch rows,
    counted on the host from the positions and the mask (each row's kept
    key positions sorted, each query's range by binary search)."""
    qp, kp, keep = (t.cpu().numpy() for t in (q_pos, k_pos, kv_mask))
    total = 0
    for b in range(qp.shape[0]):
        keys = np.sort(kp[b][keep[b]].astype(np.int64))
        q = qp[b].astype(np.int64)
        hi = np.searchsorted(keys, q, side="right") if causal else np.full(q.shape, keys.size)
        lo = (np.searchsorted(keys, q - int(window), side="right") if window is not None
              else np.zeros(q.shape, np.int64))
        total += int(np.maximum(hi - lo, 0).sum())
    return total


def flash_counts() -> dict:
    """The two flash wrappers' launch counters."""
    from repro_torch.kernels.flash_attention import ops as fl

    return {f"{fn.__name__}.{c}": getattr(fn, c)
            for fn in (fl.flash_attention, fl.flash_attention_bwd)
            for c in ("launches", "launches_tc", "launches_simt", "launches_pos")}


def require_flash_launches(before: dict, route: str, positions: bool, what: str):
    """Fails unless the forward and the backward each launched once since
    ``before``, on ``route``, on the positions route iff ``positions``."""
    after = flash_counts()
    for fn in ("flash_attention", "flash_attention_bwd"):
        want = {"launches": 1, f"launches_{route}": 1, "launches_pos": int(positions)}
        got = {c: after[f"{fn}.{c}"] - before[f"{fn}.{c}"] for c in want}
        if got != want:
            raise AssertionError(f"{what}: {fn} launched {got}, expected {want}")


def positions_case(what, q, k, v, do, q_pos, k_pos, kv_mask, causal, window, pad,
                   as_index=False, nokey_do_zero=False):
    """One case of the flash kernels' positions route on the card.

    Forward and backward are held row by row (``FLASH_ROW``) to their plain
    versions on the same inputs, the rows that keep no key flagged alike
    (lse ``NEG_INF``); then the index route on the same q, k, v is held to
    its plain version, with its one launch each, none on the positions
    route. Then the times (CUDA events): both routes, the plain versions,
    and ``scaled_dot_product_attention`` with the same boolean mask ``[B,
    1, Sq, Sk]`` (kv expanded to H heads) forward and backward as the
    library call; the bound is the kept pairs, counted on the host, × 4·D
    flops forward and × 10·D backward at the tensor-core bf16 rate (f32:
    the f32 units' rate), or the bytes if larger. The tiles visited are
    read back from the card and held to the rule (:func:`walk_counts`).
    With ``nokey_do_zero`` the backward runs once more with dO zero on the
    rows that keep no key, whose closed-form terms then vanish, so that its
    dK and dV are held to the plain version by the walk alone. With ``as_index``
    (positions 0..S−1, no key masked) the positions route's out, lse, dq,
    dk and dv are also compared with the index route's on the same inputs,
    bit for bit (``max|Δ|`` per tensor, reported). Returns the forward's
    and the backward's rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fl

    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = d**-0.5
    pos = dict(q_pos=q_pos, k_pos=k_pos, kv_mask=kv_mask)
    route = fl.route(q.dtype, d)
    before = flash_counts()
    out, lse = fl.flash_attention(q, k, v, causal, window, scale, True, True, pad=pad, **pos)
    grads = fl.flash_attention_bwd(q, k, v, out, lse, do, causal, window, scale, True, **pos)
    require_flash_launches(before, route, True, f"positions route, {what}")
    seen = (fl.visited(fl.flash_attention), fl.visited(fl.flash_attention_bwd))
    want, want_lse = fl.flash_attention_plain(q, k, v, causal, window, scale, True, True,
                                              pad=pad, **pos)
    flash_row_check(out, want, f"positions route, {what}")
    empty = want_lse == fl.NEG_INF
    if not torch.equal(lse == fl.NEG_INF, empty):
        raise AssertionError(f"positions route, {what}: the rows that keep no key differ")
    fwd_err = float((out.float() - want.float()).abs().max())
    del want, want_lse
    want = fl.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, window, scale, True,
                                        **pos)
    bwd_err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        flash_row_check(g, w, f"positions route backward {name}, {what}")
        bwd_err = max(bwd_err, float((g.float() - w.float()).abs().max()))
    del want, grads
    walk_only_err = None
    if nokey_do_zero:  # the walk's dK, dV without the no-key rows' terms
        do0 = do.masked_fill(empty[..., None], 0)
        got = fl.flash_attention_bwd(q, k, v, out, lse, do0, causal, window, scale, True,
                                     **pos)
        want = fl.flash_attention_bwd_plain(q, k, v, out, lse, do0, causal, window, scale,
                                            True, **pos)
        walk_only_err = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            flash_row_check(g, w, f"positions route backward {name}, dO zero on the rows "
                                  f"that keep no key, {what}")
            walk_only_err = max(walk_only_err, float((g.float() - w.float()).abs().max()))
        del do0, got, want
    before = flash_counts()
    iout, ilse = fl.flash_attention(q, k, v, causal, window, scale, True, True)
    igrads = fl.flash_attention_bwd(q, k, v, iout, ilse, do, causal, window, scale, True)
    require_flash_launches(before, route, False, f"index route, {what}")
    flash_row_check(iout, fl.flash_attention_plain(q, k, v, causal, window, scale,
                                                   round_scores=True),
                    f"index route, {what}")
    for name, g, w in zip(("dq", "dk", "dv"), igrads, fl.flash_attention_bwd_plain(
            q, k, v, iout, ilse, do, causal, window, scale, True)):
        flash_row_check(g, w, f"index route backward {name}, {what}")
    versus_index = None
    if as_index:  # the positions route's bits against the index route's
        grads = fl.flash_attention_bwd(q, k, v, out, lse, do, causal, window, scale, True,
                                       **pos)
        versus_index = {name: float((a.float() - b.float()).abs().max())
                        for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                                              (out, lse, *grads), (iout, ilse, *igrads))}
        versus_index["bit_equal"] = all(
            torch.equal(a, b) for a, b in zip((out, lse, *grads), (iout, ilse, *igrads)))
        del grads
    del igrads

    def fwd():
        return fl.flash_attention(q, k, v, causal, window, scale, round_scores=True, pad=pad,
                                  **pos)

    def bwd():
        return fl.flash_attention_bwd(q, k, v, out, lse, do, causal, window, scale, True,
                                      **pos)

    times = {
        "ms": cuda_ms(fwd, reps=5), "bwd_ms": cuda_ms(bwd, reps=5),
        "index_ms": cuda_ms(lambda: fl.flash_attention(q, k, v, causal, window, scale,
                                                       round_scores=True), reps=5),
        "index_bwd_ms": cuda_ms(lambda: fl.flash_attention_bwd(
            q, k, v, iout, ilse, do, causal, window, scale, True), reps=5),
        "plain_ms": cuda_ms(lambda: fl.flash_attention_plain(
            q, k, v, causal, window, scale, round_scores=True, pad=pad, **pos), reps=1),
        "plain_bwd_ms": cuda_ms(lambda: fl.flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal, window, scale, True, **pos), reps=1),
    }
    del iout, ilse
    mask = fl.keep_mask(q_pos[:, None], k_pos[:, None], causal, window, kv_mask[:, None])
    kx, vx = (t.repeat_interleave(h // hkv, 1) for t in (k, v))
    try:
        times["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask, scale=scale), reps=5)
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, kx, vx))
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)
        times["library_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do, retain_graph=True), reps=5)
        del ql, kl, vl, lib_out
    except RuntimeError as exc:  # no backend takes this call: say so
        times.setdefault("library_ms", None)
        times["library_bwd_ms"] = None
        times["library_refused"] = str(exc).splitlines()[0][:300]
    del mask, kx, vx
    pairs = kept_pairs_host(q_pos, k_pos, kv_mask, causal, window)
    rate = BF16_TENSOR_OPS_PER_S if route == "tc" else SCALAR_OPS_PER_S
    size = q.element_size()
    pos_bytes = 4 * (q_pos.numel() + k_pos.numel()) + kv_mask.numel()
    f_bytes = (2 * q.numel() + 2 * k.numel()) * size + pos_bytes
    b_bytes = (4 * q.numel() + 4 * k.numel()) * size + lse.numel() * 4 + pos_bytes
    f_bound, f_by = bound(f_bytes, pairs * h * 4 * d, rate)
    b_bound, b_by = bound(b_bytes, pairs * h * 10 * d, rate)
    shape = (f"q {str(q.dtype)[6:]}[{b},{h},{sq},{d}], kv [{b},{hkv},{sk},{d}], "
             f"{'causal' if causal else 'not causal'}, window {window}, pad {pad} ({what})")
    walk = walk_counts(*seen, q_pos, k_pos, kv_mask, h, sq, sk, causal, window, route)
    common = {"route": "cuda", "kernel_route": f"positions, {route}", "launches": 0,
              "launches_positions_phase": 1, "shape": shape, "kept_pairs_per_head": pairs,
              "rows_keeping_no_key": int(empty.sum()),
              "library": "scaled_dot_product_attention(bool attn_mask [B,1,Sq,Sk], "
                         f"kv expanded to {h} heads), forward or backward"}
    if versus_index is not None:
        common["versus_index_route"] = versus_index
    if walk_only_err is not None:
        common["bwd_max_abs_err_nokey_do_zero"] = walk_only_err
    fwd_row = {
        "name": "flash_attention", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "semantics": "src/repro/models/transformer/attention.py:87 attention_chunked",
        "max_abs_err": fwd_err, "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": f_bound, "bound_by": f_by, "library_ms": times["library_ms"],
        "index_route_ms": times["index_ms"], "bound_share": f_bound / times["ms"],
        **walk["fwd"], **common}
    bwd_row = {
        "name": "flash_attention_bwd", "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/transformer/attention.py:188",
        "max_abs_err": bwd_err, "ms": times["bwd_ms"], "plain_ms": times["plain_bwd_ms"],
        "bound_ms": b_bound, "bound_by": b_by, "library_ms": times["library_bwd_ms"],
        "index_route_ms": times["index_bwd_ms"], "bound_share": b_bound / times["bwd_ms"],
        **walk["bwd"], **common}
    if "library_refused" in times:
        fwd_row["library_refused"] = bwd_row["library_refused"] = times["library_refused"]
    return [fwd_row, bwd_row]


def positions_inputs(seed, device):
    """The positions phase's cases in order, each ``(what, tensors,
    options)``: ``tensors`` q, k, v, dO, q_pos, k_pos and kv_mask on the
    card from ``seed``, ``options`` the rest of :func:`positions_case`'s
    arguments. (a) a left-padded batch of ``POSITIONS_LENGTHS`` prompts in
    ``POSITIONS_SLOTS`` slots, bf16 on the tensor cores, at h2o-danube's
    and deepseek-moe's attention, the pad rows keeping no key (h2o's also
    with dO zero on them); (b) positions 0..S−1 with no key masked at
    h2o-danube's shape, against the index route's bits; (c) a batch whose
    last row keeps no key at all (``POSITIONS_EMPTY_ROW``), bf16; (d)
    random positions with a window and 10 % of the keys masked, f32 on the
    SIMT route, at a small shape whose JAX chunk pads; (e) (c) in f32 on
    the SIMT route. :func:`positions_phase` and :func:`positions_profile`
    both run these."""
    gen = torch.Generator(device=device).manual_seed(seed + 26)

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dt)

    def qkvd(b, h, hkv, sq, sk, d, dt):
        return tuple(rnd(shape, dt) for shape in ((b, h, sq, d), (b, hkv, sk, d),
                                                  (b, hkv, sk, d), (b, h, sq, d)))

    b, s = len(POSITIONS_LENGTHS), POSITIONS_SLOTS
    pads = torch.tensor([s - n for n in POSITIONS_LENGTHS], dtype=torch.int32, device=device)
    pos = (torch.arange(s, dtype=torch.int32, device=device)[None] - pads[:, None]).contiguous()
    for arch, h, hkv, d, causal, window in POSITIONS_SHAPES:
        qkv = qkvd(b, h, hkv, s, s, d, torch.bfloat16)
        yield (f"{arch}'s attention, left-padded prompts of "
               f"{'/'.join(map(str, POSITIONS_LENGTHS))} tokens", (*qkv, pos, pos, pos >= 0),
               dict(causal=causal, window=window, pad=0,
                    nokey_do_zero=arch == "h2o-danube-1.8b"))
        if arch == "h2o-danube-1.8b":  # 0..S-1, no mask: the index route's bits
            ar = torch.arange(s, dtype=torch.int32, device=device).repeat(b, 1)
            yield (f"{arch}'s attention, positions 0..S-1, no key masked",
                   (*qkv, ar, ar, torch.ones_like(ar, dtype=torch.bool)),
                   dict(causal=causal, window=window, pad=0, as_index=True))
        del qkv
        torch.cuda.empty_cache()

    def empty_row(dt):
        b, h, hkv, s, d, pad = POSITIONS_EMPTY_ROW
        qkv = qkvd(b, h, hkv, s, s, d, dt)
        ar = torch.arange(s, dtype=torch.int32, device=device).repeat(b, 1)
        ar[0] -= pad
        kv_mask = ar >= 0
        kv_mask[-1] = False
        return (f"left-padded row and a row that keeps no key ({pad} pads, then every key "
                f"masked), {str(dt)[6:]}", (*qkv, ar, ar.clone(), kv_mask),
                dict(causal=True, window=None, pad=0))

    yield empty_row(torch.bfloat16)
    b, h, hkv, sq, sk, d, window, chunk_kv = POSITIONS_SIMT
    qkv = qkvd(b, h, hkv, sq, sk, d, torch.float32)
    q_pos = torch.randint(0, sk + 100, (b, sq), generator=gen, device=device,
                          dtype=torch.int32)
    k_pos = torch.randint(0, sk + 100, (b, sk), generator=gen, device=device,
                          dtype=torch.int32)
    kv_mask = torch.rand((b, sk), generator=gen, device=device) >= 0.1
    yield (f"random positions, window {window}, 10 % of keys masked",
           (*qkv, q_pos, k_pos, kv_mask),
           dict(causal=True, window=window, pad=(-sk) % min(chunk_kv, sk)))
    del qkv
    yield empty_row(torch.float32)


def positions_phase(seed, device, card):
    """The flash kernels' positions route (the JAX package's whole
    ``attention_chunked``: query and key positions, a key mask) on
    :func:`positions_inputs`' cases, each by :func:`positions_case`;
    returns the ``kernels`` rows."""
    t_phase = time.perf_counter()
    rows = []
    for what, tensors, options in positions_inputs(seed, device):
        rows += positions_case(what, *tensors, **options)
        del tensors
    for row in rows:
        say("positions_case", card, **{k_: v_ for k_, v_ in row.items()
                                       if k_ not in ("route", "source", "replaces")})
    say("positions_phase", card, seconds=time.perf_counter() - t_phase)
    return rows


def positions_profile(seed, device, card):
    """``--positions-profile``: each launch's device time (``torch.profiler``,
    CUPTI) in one forward and one backward of the positions route, and of
    the index route on the same q, k, v, on each of :func:`positions_inputs`'
    cases: where the time of the small launches (bounds, walks, column
    sums, the no-key sums and dQ) goes beside the main kernels. Prints
    ``positions_profile`` lines; no result line."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops as fl

    for what, (q, k, v, do, q_pos, k_pos, kv_mask), options in positions_inputs(seed, device):
        scale = q.shape[3]**-0.5
        causal, window = options["causal"], options["window"]
        for case, pos_args in (("positions route", dict(q_pos=q_pos, k_pos=k_pos,
                                                        kv_mask=kv_mask, pad=options["pad"])),
                               ("index route", {})):
            out, lse = fl.flash_attention(q, k, v, causal, window, scale, True, True,
                                          **pos_args)
            bwd_args = {n: t for n, t in pos_args.items() if n != "pad"}

            def both():
                fl.flash_attention(q, k, v, causal, window, scale, round_scores=True,
                                   **pos_args)
                fl.flash_attention_bwd(q, k, v, out, lse, do, causal, window, scale, True,
                                       **bwd_args)

            for _ in range(2):
                both()
            sync(device)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                both()
                sync(device)
            launches = [(e.name.replace("(anonymous namespace)::", "").replace("void ", "")
                         .split("(")[0].split("<")[0].split("::")[-1], e.device_time / 1e3)
                        for e in prof.events() if getattr(e, "device_time", 0) > 0]
            say("positions_profile", card, case=what, route=case, launches_ms=launches,
                device_ms=sum(t for _, t in launches))
            del out, lse
    return 0


def train_kernel_rows(launches, seed, device, card):
    """The backward kernels timed at the training path's shapes, each
    against its plain twin, its bound and its library call:
    ``flash_attention_bwd`` at h2o-danube's layer shape and at
    deepseek-moe's D = 128 (:func:`flash_bwd_row`); ``scatter_rows`` (a
    stable sort, then ``csrc/scatter_rows.cu``) as the bag's table gradient
    at AutoInt's ``train_batch`` lookup (a dense 39 M-row gradient) and as
    the gather's at gat-cora's ``h[src]`` read, ``segment_reduce_bwd`` as
    the segment sum's at gat-cora's aggregation (library: ``index_add_`` /
    ``index_select``). Each is held to its float64 sum (exact on k/16
    values, ``TOL`` · Σ|x| on random ones) and to itself run twice, bit for
    bit; each row carries the device time of the same calls replayed from a
    CUDA graph, the sort's share and the time of the composition PR 16 had
    (``composed_ms``: sort → ``gather_rows`` → offsets → ``segment_reduce``;
    for the segment sum, ``gather_rows`` of the cotangent by expanded ids),
    rebuilt here and timed in the same run. Bytes count each input read
    once and each output written once. Two more cases print a
    ``train_kernel_case`` line each: the gather's table gradient with a run
    of ``HUB_IDS`` ids among gat-cora's, and segment max and min with planted
    ties and gat-cora's edge mask, bit-equal to their plain versions."""
    from repro_torch import configs
    from repro_torch.data import gnn_full_batch, recsys_batches
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.kernels import autograd as kg
    from repro_torch.kernels.gather_rows import ops as gops
    from repro_torch.kernels.scatter_rows import ops as cops
    from repro_torch.kernels.segment_reduce import ops as sops

    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=device, dtype=dt)

    rows = [flash_bwd_row(LM_TRAIN_BATCH, 32, 8, LM_TRAIN_SEQ, 80, 4096,
                          launches["h2o-danube-1.8b"]["flash_attention_bwd"],
                          "h2o-danube-1.8b's training shape", gen, device),
            flash_bwd_row(LM_TRAIN_BATCH, 16, 16, LM_TRAIN_SEQ, 128, None, 0,
                          "deepseek-moe-16b's attention at 4,096 tokens (not on the "
                          "path: it trains on the CPU only)", gen, device)]

    def twice(fn, what):
        a, b = fn(), fn()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two calls differ")
        return a

    def hold_scatter(fn, g, rows, n, what):
        """``fn(g)``, a gradient summed by ``rows`` into ``n`` rows, held to
        its float64 sum on the card: within ``TOL`` · Σ|x| for the row's
        random ``g``, exact for k/16 values of its shape; bit-equal twice."""
        err = 0.0
        for exact in (False, True):
            g_ = (torch.randint(-16, 17, g.shape, generator=gen, device=device).float() / 16
                  if exact else g)
            want, mag = host_scatter(g_, rows, n, device)
            got = twice(lambda: fn(g_), what)
            err = max(err, hold_sum(got, want, mag, exact,
                                    f"{what}, {'k/16' if exact else 'random'} values"))
            del want, mag, g_, got
        return err

    def composed(values, ids, n):
        """PR 16's table gradient, rebuilt to be timed beside the kernel."""
        sorted_ids, perm = torch.sort(ids, stable=True)
        ordered = gops.gather_rows(values, perm.to(torch.int32))
        return sops.segment_reduce(ordered, sorted_ids, n, "sum",
                                   offsets=segment_offsets(sorted_ids, n))

    def both(fn, graph_reps):
        return cuda_ms(fn, reps=5), graph_ms(fn, reps=graph_reps)

    def kernel_row(perf_row, name, fn, err, library, prior, sort, nbytes, replaces, n_launches,
                   shape, lib_name, composed_of, graph_reps=20):
        with plain_kernels():
            want = fn()
        got = fn()
        t_bound, t_by = bound(nbytes, 0)
        ms, g_ms = both(fn, graph_reps)
        lib_ms, lib_g = both(library, graph_reps)
        prior_ms, prior_g = both(prior, graph_reps)
        row = {
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": max(err, float((got.float() - want.float()).abs().max())),
            "ms": ms, "plain_ms": cuda_ms(lambda: _plain_call(fn), reps=2),
            "bound_ms": t_bound, "bound_by": t_by, "library_ms": lib_ms, "library": lib_name,
            "shape": shape, "bound_share": t_bound / ms, "perf_row": perf_row,
            "composed_of": composed_of, "graph_ms": g_ms, "library_graph_ms": lib_g,
            "composed_ms": prior_ms, "composed_graph_ms": prior_g,
        }
        if sort is not None:
            row["sort_ms"], row["sort_graph_ms"] = both(sort, graph_reps)
            row["sort_share"] = row["sort_graph_ms"] / g_ms
        del got, want
        return row

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
    err = hold_scatter(lambda g_: kg.embedding_bag_backward(g_, table, idx, None)[0], g, flat,
                       vrows, "embedding_bag backward at AutoInt's train_batch")
    rows.append(kernel_row(
        "3b", "scatter_rows", lambda: kg.embedding_bag_backward(g, table, idx, None)[0], err,
        lambda: torch.zeros_like(table).index_add_(0, flat, g),
        lambda: composed(g, idx.reshape(-1).clamp(0, vrows - 1), vrows),
        lambda: torch.sort(idx.reshape(-1), stable=True),
        (g.numel() + idx.numel() + table.numel()) * 4,
        "src/repro/kernels/embedding_bag/kernel.py:42",
        launches["autoint"]["scatter_rows"],
        f"d_table f32[{vrows},{cfg.embed_dim}] from {idx.shape[0]} one-slot bags "
        "(AutoInt train_batch lookup; embedding_bag's table gradient)", "zeros + index_add_",
        "clamp, torch.sort of the int32 ids, csrc/scatter_rows.cu", graph_reps=2))
    del table, g, flat, idx, fields
    torch.cuda.empty_cache()

    gcfg = configs.resolve_gnn_config(configs.get_spec("gat-cora").config, "full_graph_sm",
                                      configs.get_spec("gat-cora").shapes["full_graph_sm"])
    batch = gnn_full_batch(16 * GAT_TRAIN_BATCH, 6.0, gcfg.d_in, gcfg.n_out, seed=seed,
                           device=device)
    n, src, dst = batch["x"].shape[0], batch["src"], batch["dst"]
    width = gcfg.n_heads * gcfg.d_hidden
    g = rnd((src.shape[0], gcfg.n_heads, gcfg.d_hidden))
    src_l = src.long().clamp(0, n - 1)
    err = hold_scatter(lambda g_: kg.gather_rows_backward(g_, src, n, None), g, src_l, n,
                       "gather_rows backward at gat-cora's h[src]")
    rows.append(kernel_row(
        "1e", "scatter_rows", lambda: kg.gather_rows_backward(g, src, n, None), err,
        lambda: torch.zeros((n, gcfg.n_heads, gcfg.d_hidden), device=device).index_add_(
            0, src_l, g),
        lambda: composed(g, src.clamp(0, n - 1), n),
        lambda: torch.sort(src, stable=True),
        (g.numel() + src.numel() + n * width) * 4,
        "src/repro/kernels/gather_rows/kernel.py:20",
        launches["gat-cora"]["scatter_rows"],
        f"d_h f32[{n},{gcfg.n_heads},{gcfg.d_hidden}] from {src.shape[0]} rows "
        "(gat-cora's h[src], Cora shape; gather_rows' table gradient)", "zeros + index_add_",
        "clamp, torch.sort of the int32 ids, csrc/scatter_rows.cu"))

    # a run of HUB_IDS ids of one row among gat-cora's: the kernel's tiles
    # and the fix-up's walk over ~HUB_IDS / 512 of them
    hub = torch.cat([src, torch.full((HUB_IDS,), 7, dtype=torch.int32, device=device)])
    hub = hub[torch.randperm(hub.shape[0], generator=gen, device=device)]
    gh = rnd((hub.shape[0], gcfg.n_heads, gcfg.d_hidden))
    err = hold_scatter(lambda g_: kg.gather_rows_backward(g_, hub, n, None), gh,
                       hub.long(), n, "gather_rows backward with a hub run")
    say("train_kernel_case", card, case="scatter_rows, a hub run", run=HUB_IDS,
        ids=hub.shape[0], max_abs_err=err,
        ms=cuda_ms(lambda: kg.gather_rows_backward(gh, hub, n, None)),
        graph_ms=graph_ms(lambda: kg.gather_rows_backward(gh, hub, n, None)))
    del hub, gh

    go = rnd((n, gcfg.n_heads, gcfg.d_hidden))
    dst_l = dst.long().clamp(0, n - 1)
    offsets = segment_offsets(dst, n)
    emask = batch["emask"]
    # the sum's backward is a gather: exactly the cotangent of each kept row
    keep = ((dst >= 0) & (dst < n) & emask).reshape(-1, 1, 1)
    exact = torch.where(keep, go.index_select(0, dst_l), 0.0).double()
    hold_sum(twice(lambda: kg.segment_reduce_backward(go, None, None, dst, n, "sum", emask,
                                                      offsets), "segment sum backward"),
             exact, None, True, "segment sum backward at gat-cora's aggregation")
    del keep, exact
    rows.append(kernel_row(
        "2d", "segment_reduce_bwd",
        lambda: kg.segment_reduce_backward(go, None, None, dst, n, "sum", emask, offsets), 0.0,
        lambda: go.index_select(0, dst_l),
        lambda: gops.gather_rows(go, torch.where((dst >= 0) & (dst < n) & emask, dst, n)
                                 .to(torch.int32), 0.0),
        None,
        (go.numel() + g.numel()) * 4 + offsets.numel() * 4 + emask.numel(),
        "src/repro/kernels/segment_reduce/kernel.py:55",
        launches["gat-cora"]["segment_reduce_bwd"],
        f"d_vals f32[{src.shape[0]},{gcfg.n_heads},{gcfg.d_hidden}] from {n} segments "
        "(gat-cora's aggregation, a sum; segment_reduce's values gradient)", "index_select",
        "csrc/segment_reduce_bwd.cu (sum: one launch over the saved offsets)"))

    # max and min with planted ties (values k/4) under gat-cora's edge mask,
    # bit-equal to the plain version on the card, and twice
    vals = (torch.randint(-3, 4, g.shape, generator=gen, device=device).float() / 4)
    for op in ("max", "min"):
        out = sops.segment_reduce(vals, dst, n, op, mask=emask, offsets=offsets)
        fn = lambda: kg.segment_reduce_backward(go, vals, out, dst, n, op, emask, offsets)  # noqa: E731
        got = twice(fn, f"segment {op} backward")
        want = sops.segment_reduce_bwd_plain(go, vals, out, dst, n, op, emask, offsets)
        if not torch.equal(got, want):
            raise AssertionError(f"segment {op} backward with ties differs from its plain "
                                 f"version by {float((got - want).abs().max())}")
        say("train_kernel_case", card, case=f"segment_reduce_bwd {op}, ties and a mask",
            rows=vals.shape[0], tie_rows=int((got != 0).any(-1).any(-1).sum()),
            ms=cuda_ms(fn), graph_ms=graph_ms(fn))
    return rows


# -- 9. the models on the mesh -----------------------------------------------

#: the mesh phase's gloo ranks on the one card and their meshes: the GNNs
#: on ("data", "model") = (2, 2), deepseek-moe-16b expert-parallel on
#: (1, 4), the trainer on launch.train's (world, 1) at 2 ranks
MESH_RANKS = 4
MESH_GNN_SHAPE, MESH_MOE_SHAPE, MESH_TRAIN_RANKS = (2, 2), (1, 4), 2
#: the GNNs held on the mesh to their one-rank forward (graphcast on
#: full_graph_sm; the others on ogb_products)
MESH_GNN = ("pna", "gat-cora", "graphcast")
#: the MoE serve on the mesh against the one-rank serve: each step's
#: logits within this share of the one-rank's max|logit| (the LM check's)
MESH_LOGIT_TOL = 3e-2
MESH_TRANSPORT = "gloo ranks sharing one card: correctness runs, not multi-card times"


def mesh_rank(rank, port, device, shared, queue):
    """One gloo rank of the mesh phase, on ``device`` (every rank on the one
    card): runs its job (``shared``: ``[job]``, its tensors the parent's, by
    CUDA IPC; emptied here so that they are released when this returns)
    on the job's mesh and reports to ``queue``."""
    import datetime
    import traceback

    import torch.distributed as dist

    (job,) = shared
    shared.clear()
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=job["world"], timeout=datetime.timedelta(seconds=300),
        )
        if device.type == "cuda":
            torch.cuda.set_device(torch.device("cuda", rank % torch.cuda.device_count()))
            torch.cuda.reset_peak_memory_stats()
        report = {"gnn": _mesh_gnn_rank, "moe": _mesh_moe_rank, "train": _mesh_train_rank,
                  "probe": _mesh_probe_rank,
                  "serve": lambda r, j, d: _mesh_tp_serve(j["serve"], d)}[job["kind"]](
                      rank, job, device)
        report["peak_allocated_gb"] = peak_gb(device)
        queue.put((rank, report))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _mesh_check(arch, got, want, tol, whole=None):
    """``got`` held to ``want`` (rows of ``whole``) by ``gnn_serve``'s rule
    for ``arch`` (:func:`gnn_check`): (max|Δ|, max|want|, the rule)."""
    err, scale, check, past = gnn_check(arch, got, want, tol, whole)
    if past:
        raise AssertionError(f"mesh {arch}: past {check} against the one-rank forward at a "
                             f"share {past} of the elements: max|Δ| {err}, max|out| {scale}")
    return err, scale, check


#: the GNN layer functions whose first output is a rank's activation
#: between layers (``mesh_gnn``'s ``activation_gb``)
GNN_LAYERS = ("sage_layer", "gat_layer", "pna_layer_fused", "mpnn_layer_fused")


@contextlib.contextmanager
def first_layer_output(out: list):
    """The GNN layer functions wrapped while inside: the first layer's
    output (a tuple: ``h``, and GraphCast's ``e``) appended to ``out``."""
    from repro_torch.models.gnn import layers as L

    saved = {name: getattr(L, name) for name in GNN_LAYERS}

    def record(fn):
        def wrapped(*args, **kwargs):
            y = fn(*args, **kwargs)
            if not out:
                out.append(y if isinstance(y, tuple) else (y,))
            return y

        return wrapped

    for name, fn in saved.items():
        setattr(L, name, record(fn))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            setattr(L, name, fn)


def _rank_bytes(tensors):
    """(this rank's bytes, the whole tensors' bytes) of node and edge
    tensors, flat DTensors at their local rows."""
    from repro_torch.dist import sharding as shd

    mine = sum(shd.local_rows(t).numel() * t.element_size() for t in tensors)
    return mine, sum(t.numel() * t.element_size() for t in tensors)


def _mesh_gnn_rank(rank, job, device):
    """Each model's ``forward`` on the (2, 2) mesh, the rank holding only
    its block of the graph (``launch.train.shard_graph``: views of the
    parent's tensors): its block of the output held to the same rows of the
    parent's one-rank output, its launches per route equal to the one-rank
    forward's, the fused PNA layer's three reduce-scatters a layer counted;
    the rank's batch and first-layer activation bytes beside the whole
    ones, and its peak."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import shard_graph
    from repro_torch.models.gnn import models as gm

    mesh = make_mesh(job["shape"], ("data", "model"), device=device)
    shd.activate(mesh)
    out = {}
    for m in job["models"]:
        cfg = m["cfg"]
        batch = shard_graph(m["batch"], mesh)
        batch_bytes = _rank_bytes(batch.values())
        reset_peak(device)
        graph_counters(zero=True)
        coll.reset_counts()
        sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        with torch.no_grad(), first_layer_output([]) as first:
            y = gm.forward(m["params"], batch, cfg)
        sync(device)
        wall = time.perf_counter() - t0
        launches, collectives = graph_counters(), coll.reset_counts()
        if tuple(y.shape) != tuple(m["want"].shape):
            raise AssertionError(f"mesh {m['arch']}: output {tuple(y.shape)}")
        local, start = shd.local_rows(y), shd.row_start(y)
        rows = slice(start, start + local.shape[0])
        err, scale, check = _mesh_check(m["arch"], local, m["want"][rows].to(y.device),
                                        GNN_TOL[cfg.compute_dtype], whole=m["want"])
        if device.type == "cuda" and launches != m["launches"]:
            raise AssertionError(f"mesh {m['arch']} rank {rank}: launches {launches}, the "
                                 f"one-rank forward's {m['launches']}")
        e = batch["src"].shape[0]
        fused = cfg.variant in ("pna", "graphcast") and e % mesh.size == 0
        per_layer = {"pna": 3, "graphcast": 1}.get(cfg.variant, 0)
        if fused and collectives.get("reduce_scatter", 0) != per_layer * cfg.n_layers:
            raise AssertionError(f"mesh {m['arch']}: {collectives} for the fused branch")
        out[m["arch"]] = {
            "wall_s": wall, "max_abs_diff": err, "max_abs_out": scale,
            "check": check, "rows": [rows.start, rows.stop], "output_split": shd.is_flat(y),
            "branch": "fused" if fused else "composable" if per_layer else "mp_* ops",
            "n_edges": e, "edges_per_rank": shd.local_rows(batch["src"]).shape[0],
            "batch_bytes": batch_bytes, "activation_bytes": _rank_bytes(first[0]),
            "peak_gb": peak_gb(device), "launches": launches, "collectives": collectives}
        del y, local, first, batch
    shd.deactivate()
    return {"models": out, "transport": coll.transport()}


def mesh_gnn(models, device, card):
    """The GNNs on the (2, 2) mesh: ``MESH_RANKS`` gloo ranks on the one
    card, each model's graph, weights and one-rank output shared by CUDA
    IPC, each rank taking its block of the graph. Prints a ``mesh_gnn``
    line per model; returns the launches over the ranks."""
    t0 = time.perf_counter()
    if device.type == "cuda":  # the ranks allocate beside this process's cache
        torch.cuda.empty_cache()
    job = {"kind": "gnn", "world": MESH_RANKS, "shape": MESH_GNN_SHAPE, "models": models}
    reports, ranks_s = run_ranks([job], device, target=mesh_rank, world=MESH_RANKS,
                                 what="mesh gnn")
    del job
    if device.type == "cuda":  # blocks shared by CUDA IPC wait here until collected
        torch.cuda.ipc_collect()
    total = {}
    for m in models:
        arch = m["arch"]
        per_rank = [reports[r]["models"][arch] for r in range(MESH_RANKS)]
        whole = per_rank[0]["n_edges"] % MESH_RANKS == 0
        if arch == "pna" and whole and per_rank[0]["branch"] != "fused":
            raise AssertionError(f"mesh pna took the {per_rank[0]['branch']} branch")
        n = m["want"].shape[0]
        covered = sorted(tuple(rep["rows"]) for rep in per_rank)
        split = n % MESH_RANKS == 0
        if covered != ([(r * n // MESH_RANKS, (r + 1) * n // MESH_RANKS)
                        for r in range(MESH_RANKS)] if split else [(0, n)] * MESH_RANKS):
            raise AssertionError(f"mesh {arch}: the ranks' output rows {covered}")
        if any(rep["output_split"] != split for rep in per_rank):
            raise AssertionError(f"mesh {arch}: output split {per_rank[0]['output_split']}")
        for rep in per_rank:
            add_launches(total, rep["launches"])
        say("mesh_gnn", card, arch=arch, mesh=dict(zip(("data", "model"), MESH_GNN_SHAPE)),
            compute_dtype=m["cfg"].compute_dtype, branch=per_rank[0]["branch"],
            n_nodes=n, n_edges=per_rank[0]["n_edges"],
            edges_per_rank=per_rank[0]["edges_per_rank"],
            output_rows_per_rank=[rep["rows"] for rep in per_rank],
            wall_s=[rep["wall_s"] for rep in per_rank],
            one_rank_warm_ms=m.get("one_rank_ms"),
            max_abs_diff=max(rep["max_abs_diff"] for rep in per_rank),
            max_abs_out=per_rank[0]["max_abs_out"], tol=GNN_TOL[m["cfg"].compute_dtype],
            check=per_rank[0]["check"],
            batch_gb_per_rank=[rep["batch_bytes"][0] / 1e9 for rep in per_rank],
            batch_gb_whole=per_rank[0]["batch_bytes"][1] / 1e9,
            activation_gb_per_rank=[rep["activation_bytes"][0] / 1e9 for rep in per_rank],
            activation_gb_whole=per_rank[0]["activation_bytes"][1] / 1e9,
            peak_gb_per_rank=[rep["peak_gb"] for rep in per_rank],
            one_rank_peak_gb=m.get("one_rank_peak_gb"),
            launches_per_rank=per_rank[0]["launches"],
            collectives_per_rank=per_rank[0]["collectives"],
            peak_allocated_gb=[reports[r]["peak_allocated_gb"] for r in range(MESH_RANKS)],
            transport=MESH_TRANSPORT, collective_transport=reports[0]["transport"])
    say("mesh_phase", card, part="gnn", seconds=time.perf_counter() - t0, ranks_s=ranks_s)
    return total


#: the GNN products whose row blocks ``--row-gemm`` holds to the whole:
#: (name, rows, contraction, outputs) — GraphCast's node encoder on cora's
#: features, its head, a layer's node and edge products, PNA's head
ROW_GEMMS = (("graphcast encode_node", 4096, 1433, 512), ("graphcast head", 4096, 512, 227),
             ("graphcast node_w1", 4096, 1024, 512), ("graphcast edge_w1", 10552, 1536, 512),
             ("pna head", 4096, 75, 47))


def row_gemm_probe(device, card):
    """Each bf16 product of ``ROW_GEMMS`` on random operands, whole and in
    2 and 4 blocks of rows (a rank's share), plain (``x @ w``) and padded
    to multiples of 8 (``models.gnn.models._rows_mm``): a ``row_gemm``
    line each with the share of elements where the blocks differ from the
    whole and the largest difference."""
    from repro_torch.models.gnn import models as gm

    gen = torch.Generator(device=device).manual_seed(0)
    for name, m, k, n in ROW_GEMMS:
        x = torch.randn(m, k, generator=gen, device=device).bfloat16()
        w = (torch.randn(k, n, generator=gen, device=device) / k ** 0.5).bfloat16()
        for how, mm in (("plain", torch.matmul), ("padded", gm._rows_mm)):
            whole = mm(x, w)
            for parts in (2, 4):
                b = -(-m // parts)
                blocks = torch.cat([mm(x[i * b:(i + 1) * b], w) for i in range(parts)])
                diff = (blocks.float() - whole.float()).abs()
                say("row_gemm", card, product=name, shape=[m, k, n], how=how, parts=parts,
                    unequal_share=float((blocks != whole).float().mean()),
                    max_abs_diff=float(diff.max()), max_abs=float(whole.float().abs().max()))


@contextlib.contextmanager
def recorded_gc_layers():
    """Every GraphCast layer run inside the block recorded: a list of
    ``(params, h, e, h_out)`` (``h_out`` as the layer returns it: on a mesh
    this rank's rows)."""
    from repro_torch.models.gnn import layers as L

    fused, seen = L.mpnn_layer_fused, []

    def record(p, x, e, *args, **kwargs):
        h, e_new = fused(p, x, e, *args, **kwargs)
        seen.append((p, x, e, h))
        return h, e_new

    L.mpnn_layer_fused = record
    try:
        yield seen
    finally:
        L.mpnn_layer_fused = fused


def _mesh_probe_rank(rank, job, device):
    """GraphCast on the (2, 2) mesh against one rank, layer by layer, in its
    bf16 and in f32 compute (the same weights): each mesh layer's output
    from the one-rank layer's input (``alone``: one layer's error) and along
    the mesh's own forward (``chained``), against the one-rank layer's
    output, and the model's output: max|Δ| / max|ref|, the share of
    elements past ``gnn_serve``'s elementwise rule, the share not equal."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn import layers as L
    from repro_torch.models.gnn import models as gm

    mesh = make_mesh(job["shape"], ("data", "model"), device=device)
    batch = job["batch"]
    n = batch["x"].shape[0]
    off = gm.dst_offsets(batch["dst"], n)

    def stats(got, want, tol):
        got = shd.whole(got)  # each rank's rows gathered whole
        err, scale, _, past = gnn_check("graphcast", got, want, tol)
        return {"rel": err / scale, "past": past,
                "unequal": float((got != want).float().mean())}

    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg, tol = dataclasses.replace(job["cfg"], compute_dtype=dtype), GNN_TOL[dtype]
        with torch.no_grad(), recorded_gc_layers() as one:
            want = gm.forward(job["params"], batch, cfg)
        shd.activate(mesh)
        try:
            with torch.no_grad(), recorded_gc_layers() as chained:
                got = gm.forward(job["params"], batch, cfg)
            with torch.no_grad():
                alone = [L.mpnn_layer_fused(lp, h, e, batch["src"], batch["dst"],
                                            batch["emask"], n, offsets=off)[0]
                         for lp, h, e, _ in one]
        finally:
            shd.deactivate()
        out[dtype] = {
            "alone": [stats(a, w[3], tol) for a, w in zip(alone, one)],
            "chained": [stats(c[3], w[3], tol) for c, w in zip(chained, one)],
            "output": stats(got, want, tol), "max_abs_out": float(want.abs().max())}
        del one, chained, alone
    return {"dtypes": out}


def mesh_probe(seed, device, card):
    """GraphCast (16 × 512) on full_graph_sm, on the (2, 2) mesh against one
    rank layer by layer (:func:`_mesh_probe_rank`): a ``mesh_probe`` line
    per compute dtype (rank 0's, of the ranks' rows gathered whole)."""
    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPE_CLASSES, GNN_SHAPES
    from repro_torch.data import gnn_full_batch
    from repro_torch.models.gnn import models as gm

    sm = GNN_SHAPES["full_graph_sm"]
    cfg = configs.resolve_gnn_config(configs.get_spec("graphcast").config, "full_graph_sm",
                                     sm)
    batch = gnn_full_batch(sm["n_nodes"], GNN_AVG_DEGREE["full_graph_sm"], sm["d_feat"],
                           GNN_SHAPE_CLASSES["full_graph_sm"], seed=seed, task=cfg.task,
                           n_out=cfg.n_out, device=device)
    job = {"kind": "probe", "world": MESH_RANKS, "shape": MESH_GNN_SHAPE, "cfg": cfg,
           "batch": batch, "params": gm.init(cfg, seed=seed, device=device)}
    reports, ranks_s = run_ranks([job], device, target=mesh_rank, world=MESH_RANKS,
                                 what="mesh probe")
    for dtype, rep in reports[0]["dtypes"].items():
        say("mesh_probe", card, arch="graphcast", mesh=dict(zip(("data", "model"),
                                                                 MESH_GNN_SHAPE)),
            compute_dtype=dtype, tol=GNN_TOL[dtype], n_edges=batch["src"].shape[0],
            ranks_s=ranks_s, **rep)


@contextlib.contextmanager
def first_ep_input(out: list):
    """``moe.moe_ffn_ep`` wrapped while inside: the input of its first call
    (a layer's whole gathered sequence) copied to host memory into
    ``out``."""
    from repro_torch.models.transformer import moe

    ep = moe.moe_ffn_ep

    def wrapped(x, *args, **kwargs):
        if not out:
            out.append(x.detach().to("cpu"))
        return ep(x, *args, **kwargs)

    moe.moe_ffn_ep = wrapped
    try:
        yield out
    finally:
        moe.moe_ffn_ep = ep


def _mesh_moe_rank(rank, job, device):
    """The MoE serve of :func:`mesh_moe` on this rank of the job's mesh,
    tensor- and expert-parallel: the parent's weights (CUDA IPC) cut to
    this rank's blocks (``launch.train.shard_state_``: its heads, its
    shared experts' columns and rows, its experts, its vocabulary rows), a
    prefill of the prompts, then the one-rank serve's tokens fed step by
    step (teacher forcing), every layer routed to the one-rank serve's
    expert ids (``job["pins"]``, :func:`moe_routes`; the gates the rank's
    own probabilities at them). Reports each step's max|Δlogit| /
    max|logit| (this rank's vocabulary block gathered over ``model``) and
    the greedy tokens that differ within and past ``MESH_LOGIT_TOL`` ·
    max|logit|; the launches, the heads of each flash launch, the cache's
    shape; the prefill's and the first decode step's launches and peak
    (less what was allocated before, plus their arguments:
    :func:`dry_vs_card`'s measure); the rank's own routing of every layer
    (the expert ids it computed, and the slots they keep): where it
    differs from the one-rank serve's, the tokens and their log-probability
    gaps between the k-th and (k+1)-th expert, and its dropped slots; (a)
    layer 0's ``moe_ffn_ep`` on its gathered prefill input (its own
    routing) against ``moe_ffn_local`` with the whole experts on the same
    input, bit for bit, slots and drops included; (b) whether every model
    rank's own routing of every layer was alike (expert ids and kept
    slots)."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as tr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer import moe

    cfg, prompts, tokens = job["cfg"], job["prompts"], job["tokens"]
    mesh = make_mesh(job["shape"], ("data", "model"), device=device)
    tensors = job.pop("tensors")
    routed0 = {k[len("moe_"):]: v[0] for k, v in tensors["layers"].items()
               if k.startswith("moe_") and not k.startswith("moe_shared_")}
    params = tm.TransformerParams(tensors)  # views of the parent's weights
    tr.shard_state_(params, None, tr.state_layout("lm", params, mesh), ())
    del tensors
    state = sum(t.numel() * t.element_size() for t in params.parameters())
    model = shd.axis_group(mesh, ("model",))
    cuda = device.type == "cuda"

    def measured(fn, args_bytes):  # fn's result, its launches and its peak (GB)
        gc.collect()
        sync(device)
        before = torch.cuda.memory_allocated() if cuda else 0
        reset_peak(device)
        counts = dryrun.launch_counts()
        out = fn()
        sync(device)
        peak = (torch.cuda.max_memory_allocated() - before + args_bytes) / 1e9 if cuda else None
        return out, dryrun.launches_between(counts, dryrun.launch_counts()), peak

    shd.activate(mesh)
    moe_counters(zero=True)
    coll.reset_counts()
    sync(device)
    dist.barrier()
    own, flipped = [], []
    with flash_heads([]) as heads, first_ep_input([]) as first, moe_routes(own), \
            moe_routes(flipped, pins=job["pins"]):
        t0 = time.perf_counter()
        (logits, cache), prefill_launches, prefill_peak = measured(
            lambda: tm.prefill(params, prompts, cfg, capacity=job["capacity"],
                               full_logits=False),
            state + prompts.numel() * prompts.element_size())
        prefill_s = time.perf_counter() - t0
        got = [logits]
        cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        t0 = time.perf_counter()
        step, step_launches, step_peak = measured(
            lambda: tm.decode_step_(params, cache, tokens[:, :1], cfg),
            state + cache_bytes + tokens[:, :1].numel() * tokens.element_size())
        got.append(step)
        for i in range(1, tokens.shape[1] - 1):
            got.append(tm.decode_step_(params, cache, tokens[:, i:i + 1], cfg))
        sync(device)
        decode_s = time.perf_counter() - t0
    counts, collectives = moe_counters(), coll.reset_counts()
    # (b) every model rank's own routing of every layer, prefill and steps
    routes, own_slots, own_dropped = [], 0, 0
    for idx in own:
        keep = moe.dispatch_indices(idx, cfg.moe.n_experts, moe.capacity(idx.shape[0],
                                                                        cfg.moe))[1]
        routes.append(torch.cat([idx.reshape(-1), keep.to(torch.int32)]))
        own_slots, own_dropped = own_slots + keep.numel(), own_dropped + int((~keep).sum())
    mine = torch.cat(routes)
    every = coll.all_gather_rows(mine[None], model)
    routes_alike = bool((every == every[0]).all())
    own_differs = torch.cat([d for d, _ in flipped])
    own_gaps = torch.cat([g[d] for d, g in flipped])
    del mine, every, routes, own, flipped
    # (a) layer 0's expert-parallel FFN against the local one, whole experts
    x = first[0].to(device)
    own = {k[len("moe_"):]: v for k, v in params.whole_layer(params.layer(0)).items()
           if k.startswith("moe_") and not k.startswith("moe_shared_")}
    ffn = {}
    for name, fn in (("ep", lambda: moe.moe_ffn_ep(x, own, cfg.moe, *moe.ep_plan(
            x.shape[0], cfg.moe), x_summed=True)),
                     ("local", lambda: moe.moe_ffn_local(x, routed0, cfg.moe))):
        slots, dropped = moe.moe_ffn.slots, int(moe.moe_ffn.dropped)
        y, _ = fn()
        ffn[name] = (y, moe.moe_ffn.slots - slots, int(moe.moe_ffn.dropped) - dropped)
    ffn_equal = bool(torch.equal(ffn["ep"][0], ffn["local"][0]))
    ffn_counts = {name: list(v[1:]) for name, v in ffn.items()}
    shd.deactivate()
    del x, ffn, first
    errs, flips, wrong = [], 0, 0
    for i, (g, want) in enumerate(zip(got, job["logits"])):
        g = coll.all_gather_dim(g, 1, model).float()  # the whole vocabulary
        scale = float(want.abs().max())
        errs.append(float((g - want).abs().max()) / scale)
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > MESH_LOGIT_TOL * scale
        differ = g.argmax(-1).to(torch.int32) != tokens[:, i]
        wrong += int((differ & sure).sum())
        flips += int((differ & ~sure).sum())
    rep = {"prefill_s": prefill_s, "decode_s": decode_s, "launches": counts,
           "flash_heads": heads, "collectives": collectives, "rel_err_per_step": errs,
           "token_flips_within_margin": flips, "tokens_wrong_past_margin": wrong,
           "logits_shape": list(got[0].shape), "cache_shape": list(cache["k"].shape),
           "state_gb": state / 1e9, "routes_alike": routes_alike,
           "route_calls": len(got) * cfg.n_layers,
           "own_routing_differs": int(own_differs.sum()),
           "own_routing_tokens": own_differs.numel(),
           "own_routing_largest_gap": float(own_gaps.max()) if own_gaps.numel() else None,
           "own_dropped_share": own_dropped / own_slots, "ffn_equal": ffn_equal,
           "ffn_slots_dropped": ffn_counts, "prefill_launches": prefill_launches,
           "prefill_peak_gb": prefill_peak, "prefill_argument_gb": (
               state + prompts.numel() * prompts.element_size()) / 1e9,
           "step_launches": step_launches, "step_peak_gb": step_peak,
           "transport": coll.transport()}
    del params, cache, got
    return rep


#: the MoE serve on the mesh: deepseek-moe-16b at full width cut to this
#: many layers (the views of phase 4b's first layers), tensor- and
#: expert-parallel on ``MESH_MOE_SHAPE``: each of its prefill's layers
#: moves ~0.8 GB a rank through gloo's host copies, which 28 would not fit
#: in the smoke's time (6 until the GNN mesh phase's sharded graphs came;
#: each layer is the same code, held to the one-rank serve at the same
#: depth)
MESH_MOE_LAYERS = 4
#: the probe's decode steps (``--mesh-moe-probe``)
MESH_MOE_PROBE_STEPS = 8


def _moe_mesh_job(params, cfg, prompts, steps):
    """The one-rank serve of ``params`` (``steps`` greedy steps after
    ``prompts``), its counters and the head count of each flash launch,
    and the :func:`_mesh_moe_rank` job that feeds its tokens on
    ``MESH_MOE_SHAPE`` over views of the same weights, routed to its
    expert ids (``pins``)."""
    from repro_torch.launch import serve as srv

    moe_counters(zero=True)
    pins = []
    with flash_heads([]) as heads, moe_routes(pins):
        ref = srv.serve(params, cfg, prompts, steps)
    ref_counts = moe_counters()
    tensors = {"embed": params.embed.data, "ln_f": params.ln_f.data,
               "layers": {k: v.data for k, v in params.layers.items()}}
    if params.unembed is not None:
        tensors["unembed"] = params.unembed.data
    job = {"kind": "moe", "world": MESH_RANKS, "shape": MESH_MOE_SHAPE, "cfg": cfg,
           "tensors": tensors, "prompts": prompts, "tokens": ref.tokens,
           "logits": [x.float() for x in ref.logits], "capacity": ref.capacity,
           "pins": pins}
    return job, ref, ref_counts, heads


def _moe_rank_dryrun(cfg, batch, prompt_len, capacity, real, device, card):
    """Rank 0's prefill and first decode step of :func:`mesh_moe` dry-run
    in a fake group on ``MESH_MOE_SHAPE`` (``launch.dryrun``: its shards,
    tensor-parallel, the decode's cache its ``C/m`` slots; fake tensors on
    ``device``) against the real rank's (``real``: :func:`_mesh_moe_rank`'s
    report): a ``dryrun_vs_card`` line each; fails unless the launches are
    equal and the peak within ``DRY_PEAK_TOL``."""
    from repro_torch.launch import dryrun
    from repro_torch.models import common
    from repro_torch.models.transformer import model as tm
    from repro_torch.roofline.analysis import HW

    hw = HW.from_card() if device.type == "cuda" else HW()
    m = MESH_MOE_SHAPE[1]
    recs = {}
    with dryrun.fake_ranks(MESH_MOE_SHAPE, ("data", "model"), device.type) as mesh, \
            common.fake_mode():
        params = tm.abstract_params(cfg, device.type)
        rank = dryrun.Rank.of("lm", batch, mesh)
        rank.place("lm", params)
        prompts = tm.input_specs(cfg, "prefill", prompt_len, rank.rows, device.type)["tokens"]
        recs["prefill"] = dryrun.trace(
            rank.run(lambda p, t: tm.prefill(p, t, cfg, capacity=capacity, full_logits=False)),
            (params, prompts), hw, math.prod(MESH_MOE_SHAPE),
            dryrun.lm_model_flops(cfg, lm_shape("prefill", prompt_len, batch)))
        kv = (cfg.n_layers, rank.rows, capacity // m, cfg.n_kv_heads, cfg.head_dim)
        cache = {"k": common.fake_tensor(kv, cfg.cdtype, device.type),
                 "v": common.fake_tensor(kv, cfg.cdtype, device.type),
                 "length": common.fake_tensor((rank.rows,), torch.int32, device.type)}
        token = common.fake_tensor((rank.rows, 1), torch.int32, device.type)
        recs["decode step"] = dryrun.trace(
            rank.run(lambda p, c, t: (tm.decode_step_(p, c, t, cfg), c)),
            (params, cache, token), hw, math.prod(MESH_MOE_SHAPE),
            dryrun.lm_model_flops(cfg, lm_shape("decode", capacity, batch)))
    real_of = {"prefill": ("prefill_launches", "prefill_peak_gb"),
               "decode step": ("step_launches", "step_peak_gb")}
    lines = []
    for what, rec in recs.items():
        mem = rec["memory"]
        line = {"cell": f"{cfg.name} {what}, rank 0 of (data, model) = {MESH_MOE_SHAPE}",
                "launches_dry": rec["launches"],
                "peak_gb_pred": mem["peak_per_device_bytes"] / 1e9,
                "argument_gb": mem["argument_bytes"] / 1e9,
                "collective_gb_pred": rec["collectives"]["total"] / 1e9,
                "step_lower_bound_s": rec["roofline"]["step_lower_bound_s"],
                "trace_s": rec["trace_s"]}
        lines.append(line)
        if device.type != "cuda":
            say("dryrun_vs_card", card, **line, rehearsal=True)
            continue
        launches_key, peak_key = real_of[what]
        hold_rank_dryrun(line, rec, real[launches_key], real[peak_key], card)
    return lines


def mesh_moe(cfg, batch, prompt_len, steps, seed, device, card, one_rank=None):
    """deepseek-moe-16b at full width, ``MESH_MOE_LAYERS`` of its layers,
    tensor- and expert-parallel on ``MESH_MOE_SHAPE`` (1, 4): each rank its
    4 of 16 heads, its shared experts' columns and rows, its 16 of 64
    experts, its ``C/4`` cache slots and vocabulary rows. The weights are
    views of phase 4b's (``one_rank``, filled by :func:`moe_path`, else
    made here from ``seed``) shared with the ranks by CUDA IPC; the
    reference is the one-rank serve of phase 4b's prompts over the same
    views. A rank's attention and shared experts round otherwise than one
    rank's (column blocks, float32 partials), so its router sees other
    activations and flips experts at near ties, which moves a bf16 logit
    row by up to 20 % of max|logit| at 6 layers (``--mesh-moe-probe``
    unpinned, PR 24): the ranks route every layer to the one-rank serve's
    expert ids, as phase 4b's check (c) pins its prefill (the gates their
    own probabilities there). Checks, every rank: each step's logits
    within ``MESH_LOGIT_TOL`` · max|logit| (the prefill's error reported
    apart from the decode steps'), the greedy tokens equal past that
    margin; the launches per route the one-rank serve's, every flash
    launch on ``H/4`` heads, the cache ``C/4`` slots, the routed and
    dropped slots the one-rank serve's; (a) layer 0's ``moe_ffn_ep`` on
    its gathered input bit-equal to ``moe_ffn_local`` on it, slots and
    drops included; (b) every layer's own routing (the expert ids the rank
    computed, and their kept slots) alike on every model rank. The own
    routing's difference from one rank's (tokens, their largest
    log-probability gap) and its dropped share are reported beside one
    rank's. Then rank 0's prefill and decode step are dry-run against the
    card (:func:`_moe_rank_dryrun`). Returns the launches over the
    ranks."""
    from repro_torch.launch import serve as srv
    from repro_torch.models.transformer import model as tm

    t0 = time.perf_counter()
    if one_rank:
        params, prompts = one_rank["params"], one_rank["prompts"]
    else:
        params = tm.init(cfg, seed=seed, device=device)
        prompts = srv.random_prompts(cfg, batch, prompt_len, seed + 1, device)
    n_layers = min(cfg.n_layers, MESH_MOE_LAYERS)
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    views = {"embed": params.embed.data, "ln_f": params.ln_f.data,
             "layers": {k: v.data[:n_layers] for k, v in params.layers.items()}}
    if params.unembed is not None:
        views["unembed"] = params.unembed.data
    layers = tm.TransformerParams(views)
    weights_gb = sum(t.numel() * t.element_size() for t in layers.parameters()) / 1e9
    job, ref, ref_counts, heads = _moe_mesh_job(layers, cut, prompts, steps)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reports, ranks_s = run_ranks([job], device, target=mesh_rank, world=MESH_RANKS,
                                 what="mesh moe")
    m = MESH_MOE_SHAPE[1]
    kernels = {k: v for k, v in ref_counts.items() if not k.startswith("moe_")}
    total = {}
    for r, rep in sorted(reports.items()):
        c = rep["launches"]
        errs = rep["rel_err_per_step"]
        if max(errs) > MESH_LOGIT_TOL:
            raise AssertionError(f"mesh moe rank {r}: max|Δlogit| / max|logit| {errs} past "
                                 f"{MESH_LOGIT_TOL}")
        if rep["tokens_wrong_past_margin"]:
            raise AssertionError(f"mesh moe rank {r}: greedy tokens differ past the margin")
        if (c["moe_slots"], c["moe_dropped"]) != (ref_counts["moe_slots"],
                                                  ref_counts["moe_dropped"]):
            raise AssertionError(f"mesh moe rank {r}: slots/dropped {c['moe_slots']}/"
                                 f"{c['moe_dropped']}, one rank {ref_counts['moe_slots']}/"
                                 f"{ref_counts['moe_dropped']}")
        if device.type == "cuda":
            require_moe_launches(c, f"mesh rank {r}", n_layers, 1, steps)
            if {k: v for k, v in c.items() if not k.startswith("moe_")} != kernels:
                raise AssertionError(f"mesh moe rank {r}: launches {c}, one rank's {kernels}")
        if rep["flash_heads"] != [h // m for h in heads]:
            raise AssertionError(f"mesh moe rank {r}: flash heads {rep['flash_heads']}, one "
                                 f"rank's {heads} over {m}")
        if rep["cache_shape"][2] * m != ref.capacity:
            raise AssertionError(f"mesh moe rank {r}: cache {rep['cache_shape']}, not "
                                 f"{ref.capacity} / {m} slots")
        ffn_counts = {tuple(v) for v in rep["ffn_slots_dropped"].values()}
        if not rep["ffn_equal"] or len(ffn_counts) != 1:
            raise AssertionError(f"mesh moe rank {r}: (a) moe_ffn_ep against moe_ffn_local: "
                                 f"equal {rep['ffn_equal']}, {rep['ffn_slots_dropped']}")
        if not rep["routes_alike"]:
            raise AssertionError(f"mesh moe rank {r}: (b) the model ranks routed differently")
        add_launches(total, {k: v for k, v in c.items() if not k.startswith("moe_")})
    dry = _moe_rank_dryrun(cut, batch, prompt_len, ref.capacity, reports[0], device, card)
    n_prompt = batch * prompt_len
    say("mesh_moe", card, arch=cfg.name, mesh=dict(zip(("data", "model"), MESH_MOE_SHAPE)),
        layers=n_layers, heads_per_rank=f"{cfg.n_heads // m} of {cfg.n_heads}",
        experts_per_rank=f"{cfg.moe.n_experts // m} of {cfg.moe.n_experts}",
        cache_slots_per_rank=f"{ref.capacity} / {m}", batch=batch, prompt_len=prompt_len,
        decode_steps=steps, weights_gb=weights_gb,
        state_gb_per_rank=[rep["state_gb"] for rep in reports.values()],
        one_rank_prefill_s=ref.prefill_s, one_rank_decode_s=ref.decode_s,
        prefill_s=[rep["prefill_s"] for rep in reports.values()],
        decode_s=[rep["decode_s"] for rep in reports.values()],
        prefill_tok_s=n_prompt / max(rep["prefill_s"] for rep in reports.values()),
        rel_logit_err_prefill=max(rep["rel_err_per_step"][0] for rep in reports.values()),
        rel_logit_err_decode=max(max(rep["rel_err_per_step"][1:]) for rep in reports.values()),
        rel_logit_err_rank0=reports[0]["rel_err_per_step"], tol=MESH_LOGIT_TOL,
        token_flips_within_margin=[rep["token_flips_within_margin"]
                                   for rep in reports.values()],
        logits_shape_rank=reports[0]["logits_shape"],
        cache_shape_rank=reports[0]["cache_shape"],
        flash_heads_per_launch=sorted(set(reports[0]["flash_heads"])),
        flash_heads_one_rank=sorted(set(heads)),
        check_a_ffn_ep_equals_local=[rep["ffn_equal"] for rep in reports.values()],
        check_a_slots_dropped=reports[0]["ffn_slots_dropped"],
        check_b_routes_alike=[rep["routes_alike"] for rep in reports.values()],
        route_calls_per_rank=reports[0]["route_calls"],
        own_routing_differs=[rep["own_routing_differs"] for rep in reports.values()],
        own_routing_tokens=reports[0]["own_routing_tokens"],
        own_routing_largest_gap=[rep["own_routing_largest_gap"] for rep in reports.values()],
        dropped_share_one_rank=ref_counts["moe_dropped"] / ref_counts["moe_slots"],
        dropped_share_own_routing=[rep["own_dropped_share"] for rep in reports.values()],
        launches_per_rank=reports[0]["launches"], collectives_per_rank=reports[0][
            "collectives"],
        prefill_peak_gb_rank0=reports[0]["prefill_peak_gb"],
        step_peak_gb_rank0=reports[0]["step_peak_gb"],
        peak_allocated_gb=[rep["peak_allocated_gb"] for rep in reports.values()],
        parent_allocated_gb=torch.cuda.memory_allocated() / 1e9
        if device.type == "cuda" else None,
        dry_peak_gb=[line["peak_gb_pred"] for line in dry],
        transport=MESH_TRANSPORT, collective_transport=reports[0]["transport"])
    del params, layers, views, job, ref, one_rank
    gc.collect()
    if device.type == "cuda":
        torch.cuda.ipc_collect()
    say("mesh_phase", card, part="moe", seconds=time.perf_counter() - t0, ranks_s=ranks_s)
    return total


def mesh_moe_probe(seed, device, card, reduced=False):
    """Where the MoE serve's logit error on the mesh comes from: the serve
    of :func:`mesh_moe` (``MESH_MOE_PROBE_STEPS`` decode steps, routed to
    the one-rank serve's expert ids) on ``MESH_MOE_SHAPE`` against one
    rank, in float32 and in bfloat16, at one layer and at
    ``MESH_MOE_LAYERS``; a ``mesh_moe_probe`` line each with every step's
    max|Δlogit| / max|logit| (the prefill's first), the tokens where the
    ranks' own routing differs from one rank's and their largest
    log-probability gap, and the dropped shares. No check holds the logits
    here: the probe reports them (``reduced``: the reduced config on 2 × 16
    prompt tokens, a CPU rehearsal). No result line."""
    from repro_torch import configs
    from repro_torch.launch import serve as srv
    from repro_torch.models.transformer import model as tm

    spec = configs.get_spec("deepseek-moe-16b")
    for dtype in ("float32", "bfloat16"):
        for layers in (1, MESH_MOE_LAYERS):
            cfg = dataclasses.replace(spec.reduced if reduced else spec.config,
                                      n_layers=layers, param_dtype=dtype, compute_dtype=dtype)
            params = tm.init(cfg, seed=seed, device=device)
            prompts = srv.random_prompts(cfg, *((2, 16) if reduced else (4, 6144)), seed + 1,
                                         device)
            job, ref, ref_counts, _ = _moe_mesh_job(params, cfg, prompts, MESH_MOE_PROBE_STEPS)
            reports, _ = run_ranks([job], device, target=mesh_rank, world=MESH_RANKS,
                                   what=f"mesh moe probe {dtype} {layers}")
            say("mesh_moe_probe", card, dtype=dtype, layers=layers,
                rel_logit_err_rank0=reports[0]["rel_err_per_step"],
                max_rel_logit_err=max(max(rep["rel_err_per_step"]) for rep in reports.values()),
                tokens_wrong_past_margin=[rep["tokens_wrong_past_margin"]
                                          for rep in reports.values()],
                own_routing_differs=[rep["own_routing_differs"] for rep in reports.values()],
                own_routing_tokens=reports[0]["own_routing_tokens"],
                own_routing_largest_gap=[rep["own_routing_largest_gap"]
                                         for rep in reports.values()],
                dropped_share_one_rank=ref_counts["moe_dropped"] / ref_counts["moe_slots"],
                dropped_share_own_routing=[rep["own_dropped_share"]
                                           for rep in reports.values()],
                check_a_ffn_ep_equals_local=[rep["ffn_equal"] for rep in reports.values()],
                check_b_routes_alike=[rep["routes_alike"] for rep in reports.values()])
            del params, job, ref
            gc.collect()
            if device.type == "cuda":
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()


def _gat_train_setup(seed, device, reduced):
    """gat-cora's training config, weights and full batch, as the training
    phase makes them."""
    from repro_torch import configs
    from repro_torch.data import gnn_full_batch
    from repro_torch.models.gnn import models as gm

    spec = configs.get_spec("gat-cora")
    cfg = spec.reduced if reduced else configs.resolve_gnn_config(
        spec.config, "full_graph_sm", spec.shapes["full_graph_sm"])
    params = gm.init(cfg, seed, device)
    fb = gnn_full_batch(16 * (4 if reduced else GAT_TRAIN_BATCH), 6.0, cfg.d_in, cfg.n_out,
                        seed=seed, task=cfg.task, n_out=cfg.n_out, device=device)
    return cfg, params, fb


def _supervised_gat(cfg, params, fb, ckpt_dir, device, step=None):
    """``TRAIN_STEPS`` steps of ``launch.train.Supervised`` over gat-cora:
    (losses, final parameters, launches, seconds); with ``step`` (a dict)
    the last step measured into it (:func:`_measure_last_step`)."""
    from repro_torch.launch.train import Supervised
    from repro_torch.models import common
    from repro_torch.models.gnn import models as gm
    from repro_torch.optim import AdamWConfig, named_leaves

    p = common.trainable(_clone_tree(params))
    run = Supervised("gnn", p, lambda q, b: gm.loss_fn(q, b, cfg), lambda i: fb,
                     AdamWConfig(lr=TRAIN_LR), warmup=TRAIN_WARMUP, total=TRAIN_STEPS,
                     ckpt_dir=ckpt_dir, ckpt_every=TRAIN_STEPS, device=device,
                     log=lambda line: None)
    if step is not None:
        _measure_last_step(run, device, step, TRAIN_STEPS)
    sync(device)
    train_counters(zero=True)
    t0 = time.perf_counter()
    run.run(TRAIN_STEPS)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = train_counters()
    final = {k: v.detach().clone() for k, v in named_leaves(run.params).items()}
    return [x for _, x in run.losses], final, launches, seconds


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.detach().clone()


def _mesh_train_rank(rank, job, device):
    """A trainer on the job's mesh: gat-cora's ``Supervised`` on ``(world,
    1)``, or the sharded cases of one arch (:func:`_supervised_case`), each
    on its ``(data, model)`` mesh over the same ranks, after its serve job
    if it has one; rank 0 drops each case's checkpoint once it is done."""
    if "cases" in job:
        from repro_torch.launch.mesh import make_mesh

        out = []
        for case in job["cases"]:
            served = _mesh_tp_serve(case["serve"], device) if case["serve"] else None
            mesh = make_mesh(case["shape"], ("data", "model"), device=device)
            rep = _supervised_case(job["arch"], job["seed"], device, job["reduced"],
                                   case["ckpt_dir"], want=job["want"], measure=job["measure"],
                                   mesh=mesh)
            out.append(dict(rep, serve=served))
            if rank == 0:  # every rank passed the checkpoint's barrier
                shutil.rmtree(case["ckpt_dir"], ignore_errors=True)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        return {"cases": out}
    step = {}
    losses, final, launches, seconds = _supervised_gat(job["cfg"], job["params"],
                                                        job["batch"], job["ckpt_dir"], device,
                                                        step)
    # numpy, not tensors: the queue would share a tensor's memory with the
    # parent, which this process outlives no further than its return
    return {"losses": losses, "final": {k: v.float().cpu().numpy() for k, v in final.items()},
            "launches": launches, "seconds": seconds, **step}


#: the sharded trainer's cases on the ``(MESH_TRAIN_RANKS, 1)`` mesh, and
#: their steps a run (each step's collectives go through the host: gloo,
#: ~0.4 GB/s on the H100 machine); the dense LM's cases run in the
#: tensor-parallel part (:data:`MESH_LM_TRAIN`), against one one-rank run
MESH_TRAIN_ARCHS = ("autoint",)
MESH_TRAIN_STEPS = 2


def _train_setup(arch, seed, device, reduced):
    """``(family, lr, cfg, params, loss_fn, batches)`` of a sharded mesh
    case, from ``launch.train.build``: h2o-danube-1.8b at full width cut to
    ``CKPT_LAYERS`` layers on ``LM_TRAIN_BATCH`` × ``LM_TRAIN_SEQ`` tokens,
    AutoInt at full width on ``train_batch``'s 65,536 rows (``reduced``:
    the reduced configs at small batches, a CPU rehearsal)."""
    from repro_torch import configs
    from repro_torch.launch import train as tr

    spec = configs.get_spec(arch)
    if spec.family == "lm":
        cfg = spec.reduced if reduced else dataclasses.replace(spec.config,
                                                               n_layers=CKPT_LAYERS)
        b, s = (4, 48) if reduced else (LM_TRAIN_BATCH, LM_TRAIN_SEQ)
        _, cfg, params, loss_fn, batches = tr.build(arch, reduced, b, s, seed, device,
                                                    config=cfg)
        return spec.family, LM_TRAIN_LR, cfg, params, loss_fn, batches
    _, cfg, params, loss_fn, batches = tr.build(arch, reduced, 64 if reduced else 65_536, 0,
                                                seed, device)
    return spec.family, TRAIN_LR, cfg, params, loss_fn, batches


def _param_distance(got, want, chunk=1 << 24):
    """``got`` against ``want`` (each ``{name: tensor}``): the relative
    global distance ‖got − want‖ / ‖want‖ over every leaf (float64 sums,
    ``chunk`` elements at a time: two ranks' copies of AutoInt's table
    would not fit the card beside their states), max|Δ| / max|want| and
    the elements that differ."""
    num = den = 0.0
    worst = scale = 0.0
    differ = 0
    for k, w in want.items():
        g, w = got[k].reshape(-1), w.reshape(-1)
        for lo in range(0, w.numel(), chunk):
            ws = w[lo:lo + chunk].double()
            d = g[lo:lo + chunk].double() - ws
            num += float(d.square().sum())
            den += float(ws.square().sum())
            worst = max(worst, float(d.abs().max()))
            scale = max(scale, float(ws.abs().max()))
            differ += int((d != 0).sum())
            del ws, d
    return {"param_rel_distance": math.sqrt(num / max(den, 1e-300)),
            "max_param_diff_over_max": worst / max(scale, 1e-30), "params_differing": differ}


def _measure_last_step(run, device, out, steps=MESH_TRAIN_STEPS):
    """Wraps the supervisor's step of ``run`` (``launch.train.Supervised``)
    so that the last of its ``steps`` steps is measured as
    :func:`dry_vs_card` measures one, into ``out``: the step's launches and
    collectives, its peak less what was allocated before it plus the step's
    arguments (a batch leaf split over the ranks at this rank's rows), and
    the run's peak up to it (``run_peak_before_gb``)."""
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import dryrun

    step_fn = run.sup.step_fn

    def measured(state, batch):
        if len(run.losses) < steps - 1:
            return step_fn(state, batch)
        gc.collect()
        sync(device)
        out["run_peak_before_gb"] = peak_gb(device)
        before = torch.cuda.memory_allocated() if device.type == "cuda" else 0
        reset_peak(device)
        counts, sent = dryrun.launch_counts(), dict(coll.COUNTS)
        result = step_fn(state, batch)
        sync(device)
        args = run.state_bytes() + _rank_bytes(batch.values())[0]
        out["step_collectives"] = {k: v - sent.get(k, 0) for k, v in coll.COUNTS.items()}
        out["step_launches"] = dryrun.launches_between(counts, dryrun.launch_counts())
        out["step_peak_gb"] = (None if device.type != "cuda" else
                               (torch.cuda.max_memory_allocated() - before + args) / 1e9)
        out["step_argument_gb"] = args / 1e9
        return result

    run.sup.step_fn = measured


def _supervised_case(arch, seed, device, reduced, ckpt_dir, want=None, measure=False,
                     mesh=None):
    """``MESH_TRAIN_STEPS`` steps of ``launch.train.Supervised`` over a
    sharded case (:data:`MESH_TRAIN_ARCHS`, the dense LM's
    :data:`MESH_LM_TRAIN`) on ``mesh`` (by default ``make_train_mesh``'s:
    one rank, or the ``(world, 1)`` mesh of its gloo ranks), parameters and
    batches built here from ``seed``, its checkpoint at the end written to
    ``ckpt_dir`` (the shards gathered into rank 0's host buffers). Returns
    the losses, launches per route, the heads of each flash forward, walls,
    collectives, the live state's bytes beside the whole state's, and the
    peak; the final parameters gathered whole (``final``), or with ``want``
    (the one rank's) their distance from it; with ``measure`` the run's
    last step measured (:func:`_measure_last_step`)."""
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tr
    from repro_torch.optim import AdamWConfig, named_leaves

    reset_peak(device)
    family, lr, cfg, params, loss_fn, batches = _train_setup(arch, seed, device, reduced)
    whole = sum(t.numel() * (t.element_size() + 8) for t in named_leaves(params).values()) + 4
    coll.reset_counts()
    run = tr.Supervised(family, params, loss_fn, batches, AdamWConfig(lr=lr),
                        warmup=TRAIN_WARMUP, total=MESH_TRAIN_STEPS, ckpt_dir=ckpt_dir,
                        ckpt_every=MESH_TRAIN_STEPS, device=device, log=lambda line: None,
                        mesh=mesh)
    del params
    step = {}
    if measure:
        _measure_last_step(run, device, step)
    sync(device)
    train_counters(zero=True)
    t0 = time.perf_counter()
    with flash_heads([]) as heads:  # run() restores the SIGTERM handler it replaced
        run.run(MESH_TRAIN_STEPS)
    sync(device)
    peaks = [p for p in (peak_gb(device), step.pop("run_peak_before_gb", None)) if p is not None]
    rep = {"losses": [x for _, x in run.losses], "seconds": time.perf_counter() - t0,
           "launches": train_counters(), "flash_heads": heads,
           "collectives": coll.reset_counts(),
           "state_bytes": run.state_bytes(), "whole_state_bytes": whole,
           "held_as_shards": len(run.shards.params),
           "run_peak_gb": max(peaks) if peaks else None, **step}
    final = {k: shd.unshard(t.detach(), run.shards.params[k]) if k in run.shards.params
             else t.detach() for k, t in named_leaves(run.params).items()}
    if want is None:
        rep["final"] = final
    else:
        rep.update(_param_distance(final, want))
    del final
    return rep


def _mesh_rank_dryrun(arch, seed, device, card, reduced, real, shape=(MESH_TRAIN_RANKS, 1)):
    """Rank 0's step of a sharded case dry-run in a fake group on the
    ``(data, model)`` mesh ``shape`` (``launch.dryrun``: its shards and its
    rows, tensor-parallel where the model axis has several ranks, fake
    tensors on ``device``) against the real rank's measured step
    (``real``: :func:`_supervised_case`'s ``step_*``): a ``dryrun_vs_card``
    line; fails unless the launches are equal and the peak within
    ``DRY_PEAK_TOL``."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import common
    from repro_torch.models.transformer import model as tm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.roofline.analysis import HW

    spec = configs.get_spec(arch)
    cfg = spec.reduced if reduced else dataclasses.replace(spec.config, n_layers=CKPT_LAYERS)
    b, s = (4, 48) if reduced else (LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    hw = HW.from_card() if device.type == "cuda" else HW()
    oc = AdamWConfig(lr=LM_TRAIN_LR)
    with dryrun.fake_ranks(shape, ("data", "model"), device.type) as mesh, \
            common.fake_mode():
        params = tm.abstract_params(cfg, device.type, trainable=True)
        opt = adamw_init(params, oc)
        rank = dryrun.Rank.of("lm", b, mesh)
        shards = rank.place("lm", params, opt)
        fn = rank.run(dryrun.train_step(lambda p, q: tm.loss_fn(p, q, cfg), oc,
                                        warmup=TRAIN_WARMUP, total=MESH_TRAIN_STEPS,
                                        group=rank.group, shards=shards))
        args = (params, opt, tm.input_specs(cfg, "train", s, rank.rows, device.type))
        rec = dryrun.trace(fn, args, hw, math.prod(shape),
                           dryrun.lm_model_flops(cfg, lm_shape("train", s, b)))
    mem = rec["memory"]
    line = {"cell": f"{cfg.name} train step, rank 0 of (data, model) = {tuple(shape)}",
            "launches_dry": rec["launches"], "peak_gb_pred": mem["peak_per_device_bytes"] / 1e9,
            "argument_gb": mem["argument_bytes"] / 1e9,
            "collective_gb_pred": rec["collectives"]["total"] / 1e9,
            "step_lower_bound_s": rec["roofline"]["step_lower_bound_s"],
            "trace_s": rec["trace_s"]}
    if device.type != "cuda":
        say("dryrun_vs_card", card, **line, rehearsal=True)
        return line
    wire = sum(v for k, v in real["step_collectives"].items() if k.endswith("_wire_bytes"))
    return hold_rank_dryrun(line, rec, real["step_launches"], real["step_peak_gb"], card,
                            argument_gb_card=real["step_argument_gb"],
                            collective_gb_card=wire / 1e9,
                            collectives_card=real["step_collectives"])


def _gnn_rank_dryrun(cfg, batch, device, card, real, shape=(MESH_TRAIN_RANKS, 1)):
    """Rank 0's step of gat-cora's trainer dry-run in a fake group on the
    ``(data, model)`` mesh ``shape`` (``launch.dryrun``: the model on the
    mesh, the rank's block of every leaf of ``batch`` the mesh divides,
    fake tensors on ``device``) against the real rank's measured step
    (``real``: the job's report, :func:`_measure_last_step`'s ``step_*``):
    a ``dryrun_vs_card`` line; fails unless the launches are equal and the
    peak within ``DRY_PEAK_TOL``."""
    from repro_torch.launch import dryrun
    from repro_torch.models import common
    from repro_torch.models.gnn import models as gm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.roofline.analysis import HW

    hw = HW.from_card() if device.type == "cuda" else HW()
    oc = AdamWConfig(lr=TRAIN_LR)
    n, e = batch["x"].shape[0], batch["src"].shape[0]
    with dryrun.fake_ranks(shape, ("data", "model"), device.type) as mesh, \
            common.fake_mode():
        params = common.trainable(gm.abstract_params(cfg, device.type))
        opt = adamw_init(params, oc)
        specs = {k: common.fake_tensor(tuple(v.shape), v.dtype, device.type)
                 for k, v in batch.items()}
        fn = dryrun.train_step(lambda p, b: gm.loss_fn(p, b, cfg), oc, warmup=TRAIN_WARMUP,
                               total=TRAIN_STEPS)
        specs, fn = dryrun.gnn_rank_batch(specs, fn, mesh, device.type)
        rec = dryrun.trace(dryrun.Rank.of("gnn", n, mesh).run(fn), (params, opt, specs), hw,
                           math.prod(shape), dryrun.gnn_model_flops(cfg, n, e))
    mem = rec["memory"]
    line = {"cell": f"{cfg.name} train step, rank 0 of (data, model) = {tuple(shape)}",
            "launches_dry": rec["launches"], "peak_gb_pred": mem["peak_per_device_bytes"] / 1e9,
            "argument_gb": mem["argument_bytes"] / 1e9,
            "collective_gb_pred": rec["collectives"]["total"] / 1e9,
            "step_lower_bound_s": rec["roofline"]["step_lower_bound_s"],
            "trace_s": rec["trace_s"]}
    if device.type != "cuda":
        say("dryrun_vs_card", card, **line, rehearsal=True)
        return line
    wire = sum(v for k, v in real["step_collectives"].items() if k.endswith("_wire_bytes"))
    return hold_rank_dryrun(line, rec, real["step_launches"], real["step_peak_gb"], card,
                            argument_gb_card=real["step_argument_gb"],
                            collective_gb_card=wire / 1e9,
                            collectives_card=real["step_collectives"])


def hold_rank_dryrun(line, rec, launches, peak, card, **fields):
    """A rank's dry-run (``rec``, its ``dryrun_vs_card`` ``line``) against
    the real rank's ``launches`` and ``peak`` (GB), ``fields`` added to the
    line: prints it; fails unless the launches are equal and the peak
    within ``DRY_PEAK_TOL``."""
    rel, abs_gb = DRY_PEAK_TOL
    within = abs(line["peak_gb_pred"] - peak) <= rel * peak + abs_gb
    line.update(launches_card=launches, launches_equal=launches == rec["launches"],
                peak_gb_card=peak, **fields, peak_tol=list(DRY_PEAK_TOL),
                peak_within_tol=within)
    say("dryrun_vs_card", card, **line)
    DRY_CELLS.append(line)
    if launches != rec["launches"]:
        raise AssertionError(f"dry-run {line['cell']}: launches {rec['launches']}, card "
                             f"{launches}")
    if not within:
        raise AssertionError(f"dry-run {line['cell']}: peak {line['peak_gb_pred']} GB "
                             f"predicted, {peak} GB on the card")
    return line


def mesh_train_sharded(arch, seed, device, card, reduced=False,
                       shapes=((MESH_TRAIN_RANKS, 1),), serves=None):
    """A sharded case on gloo ranks of each ``(data, model)`` mesh of
    ``shapes`` against one rank in this process (:func:`_supervised_case`
    in both; the meshes of one size run in one spawn of their ranks, in
    order, each after its serve job in ``serves``, a mesh shape → a
    :func:`_mesh_tp_serve` job). For each mesh: the losses within
    ``TRAIN_TOL`` relative, the parameters' relative global distance within
    ``TRAIN_TOL`` (bf16 leaves a rounding apart flip by an ulp: max|Δ| /
    max is printed beside it), each rank's launches per route equal to one
    rank's, and on a model axis of m ranks each flash forward on ``H/m``
    heads where one rank's had ``H``; a ``mesh_train`` line with each
    rank's live state beside the whole state's, its peak beside one rank's,
    its collective bytes and walls; for the LM its rank step dry-run
    (:func:`_mesh_rank_dryrun`). Returns the launches over the ranks and
    each mesh's reports by rank."""
    from repro_torch import configs

    family = configs.get_spec(arch).family
    serves = serves or {}
    runs = {}
    with tempfile.TemporaryDirectory(prefix="mesh_train_") as tmp:
        one = _supervised_case(arch, seed, device, reduced, str(Path(tmp) / "one"))
        shutil.rmtree(Path(tmp) / "one", ignore_errors=True)  # the files live in host memory
        gc.collect()  # the trainer and its supervisor hold each other: free its state
        for world in sorted({math.prod(s) for s in shapes}):
            group = [tuple(s) for s in shapes if math.prod(s) == world]
            cases = [{"shape": s, "serve": serves.get(s),
                      "ckpt_dir": str(Path(tmp) / "x".join(map(str, s)))} for s in group]
            job = {"kind": "train", "world": world, "arch": arch, "seed": seed,
                   "reduced": reduced, "want": one["final"], "measure": family == "lm",
                   "cases": cases}
            if device.type == "cuda":
                torch.cuda.empty_cache()
            reports, ranks_s = run_ranks([job], device, target=mesh_rank, world=world,
                                         what=f"mesh train {arch} on {group}")
            del job, cases
            gc.collect()
            if device.type == "cuda":
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
            for i, s in enumerate(group):
                runs[s] = ({r: rep["cases"][i] for r, rep in reports.items()}, ranks_s)
    tol = TRAIN_TOL["bfloat16" if family == "lm" and not reduced else "float32"]
    total = {}
    for shape in map(tuple, shapes):
        reports, ranks_s = runs[shape]
        m, worst = shape[1], {"loss": 0.0, "param": 0.0}
        for r, rep in sorted(reports.items()):
            for a, b in zip(rep["losses"], one["losses"]):
                worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
            worst["param"] = max(worst["param"], rep["param_rel_distance"])
            if device.type == "cuda" and rep["launches"] != one["launches"]:
                raise AssertionError(f"mesh train {arch} on {shape} rank {r}: launches "
                                     f"{rep['launches']}, one rank's {one['launches']}")
            if rep["flash_heads"] != [h // m for h in one["flash_heads"]]:
                raise AssertionError(f"mesh train {arch} on {shape} rank {r}: flash heads "
                                     f"{rep['flash_heads']}, one rank's {one['flash_heads']} "
                                     f"over {m}")
            add_launches(total, rep["launches"])
        if worst["loss"] > tol or worst["param"] > tol:
            raise AssertionError(f"mesh train {arch} on {shape}: {worst} past {tol} of the "
                                 f"one-rank run")
        say("mesh_train", card, arch=arch, ranks=math.prod(shape),
            mesh={"data": shape[0], "model": m}, steps=MESH_TRAIN_STEPS, losses=one["losses"],
            losses_rank0=reports[0]["losses"], max_rel_loss_diff=worst["loss"],
            param_rel_distance=worst["param"], tol=tol,
            max_param_diff_over_max=[rep["max_param_diff_over_max"] for rep in reports.values()],
            params_differing=[rep["params_differing"] for rep in reports.values()],
            state_gb_per_rank=[rep["state_bytes"] / 1e9 for rep in reports.values()],
            state_gb_one_rank=one["state_bytes"] / 1e9,
            whole_state_gb=one["whole_state_bytes"] / 1e9,
            leaves_held_as_shards=reports[0]["held_as_shards"],
            peak_gb_per_rank=[rep["run_peak_gb"] for rep in reports.values()],
            peak_gb_one_rank=one["run_peak_gb"],
            flash_forwards_per_rank=len(reports[0]["flash_heads"]),
            flash_heads_per_launch=sorted(set(reports[0]["flash_heads"])),
            flash_heads_one_rank=sorted(set(one["flash_heads"])),
            collectives_per_rank=[rep["collectives"] for rep in reports.values()],
            gloo_wall_s=[rep["seconds"] for rep in reports.values()], one_rank_s=one["seconds"],
            ranks_s=ranks_s, launches_per_rank=reports[0]["launches"],
            transport=MESH_TRANSPORT)
        if family == "lm":
            _mesh_rank_dryrun(arch, seed, device, card, reduced, reports[0], shape)
    return total, {s: reports for s, (reports, _) in runs.items()}


def mesh_train(seed, device, card, reduced=False):
    """gat-cora's trainer on 2 gloo ranks (``launch.train.Supervised`` on
    its ``(2, 1)`` mesh, each rank on its half of the graph's nodes and
    edges) against the same ``TRAIN_STEPS`` steps on one rank in this
    process: the losses and the final parameters within ``TRAIN_TOL``,
    each rank's launches per route, backwards included, equal to the one
    rank's, and its last step dry-run against the card
    (:func:`_gnn_rank_dryrun`); then the sharded cases of
    :data:`MESH_TRAIN_ARCHS` (:func:`mesh_train_sharded`). Returns the
    launches over the ranks."""
    t0 = time.perf_counter()
    total, ranks_s = mesh_train_gat(seed, device, card, reduced)
    for arch in MESH_TRAIN_ARCHS:
        add_launches(total, mesh_train_sharded(arch, seed, device, card, reduced)[0])
    say("mesh_phase", card, part="train", seconds=time.perf_counter() - t0, ranks_s=ranks_s)
    return total


def mesh_train_gat(seed, device, card, reduced=False):
    """gat-cora's part of :func:`mesh_train`: ``(launches over the ranks,
    the ranks' seconds)``."""
    cfg, params, fb = _gat_train_setup(seed, device, reduced)
    with tempfile.TemporaryDirectory(prefix="mesh_train_") as tmp:
        losses, final, launches, one_s = _supervised_gat(cfg, params, fb,
                                                         str(Path(tmp) / "one"), device)
        job = {"kind": "train", "world": MESH_TRAIN_RANKS, "cfg": cfg, "params": params,
               "batch": fb, "ckpt_dir": str(Path(tmp) / "ranks")}
        if device.type == "cuda":
            torch.cuda.empty_cache()
        reports, ranks_s = run_ranks([job], device, target=mesh_rank,
                                     world=MESH_TRAIN_RANKS, what="mesh train")
        del job
        if device.type == "cuda":
            torch.cuda.ipc_collect()
    tol = TRAIN_TOL[cfg.compute_dtype]
    total, worst = {}, {"loss": 0.0, "param": 0.0}
    for r, rep in sorted(reports.items()):
        for a, b in zip(rep["losses"], losses):
            worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
        for k, want in final.items():
            got = torch.from_numpy(rep["final"][k]).to(want.device)
            worst["param"] = max(worst["param"], float((got - want).abs().max())
                                 / max(float(want.abs().max()), 1e-30))
        if device.type == "cuda" and rep["launches"] != launches:
            raise AssertionError(f"mesh train rank {r}: launches {rep['launches']}, one "
                                 f"rank's {launches}")
        add_launches(total, rep["launches"])
    if worst["loss"] > tol or worst["param"] > tol:
        raise AssertionError(f"mesh train: {worst} past {tol} of the one-rank run")
    say("mesh_train", card, arch="gat-cora", ranks=MESH_TRAIN_RANKS,
        mesh={"data": MESH_TRAIN_RANKS, "model": 1}, steps=TRAIN_STEPS, losses=losses,
        losses_rank0=reports[0]["losses"], max_rel_loss_diff=worst["loss"],
        max_param_diff_over_max=worst["param"], tol=tol, one_rank_s=one_s,
        seconds=[rep["seconds"] for rep in reports.values()],
        launches_per_rank=reports[0]["launches"],
        peak_allocated_gb=[rep["peak_allocated_gb"] for rep in reports.values()],
        transport=MESH_TRANSPORT)
    _gnn_rank_dryrun(cfg, fb, device, card, reports[0])
    return total, ranks_s


# -- 9c. the dense LM tensor-parallel on the mesh -----------------------------

#: the dense LM on the mesh, h2o-danube-1.8b at full width, ``CKPT_LAYERS``
#: layers, each run against one rank: its sharded trainer with FSDP alone on
#: ``(data, model) = (MESH_TRAIN_RANKS, 1)``, then tensor- and
#: sequence-parallel over ``model`` on (1, 2) and (2, 2); its serve on (1, 2)
MESH_TP_ARCH = "h2o-danube-1.8b"
MESH_LM_TRAIN, MESH_TP_SERVE = ((MESH_TRAIN_RANKS, 1), (1, 2), (2, 2)), (1, 2)
MESH_TP_DECODE_STEPS = 8


@contextlib.contextmanager
def flash_heads(log: list):
    """Appends the head count of every flash forward the model launches
    inside (``attention.attention_chunked``'s kernel call) to ``log``."""
    from repro_torch.models.transformer import attention as attn_mod

    launch = attn_mod.flash_attention

    def counted(q, *args, **kwargs):
        log.append(q.shape[1])
        return launch(q, *args, **kwargs)

    attn_mod.flash_attention = counted
    try:
        yield log
    finally:
        attn_mod.flash_attention = launch


def _mesh_tp_serve(job, device):
    """The one-rank serve's traffic tensor-parallel on this rank of the
    job's mesh: the parent's weights (CUDA IPC) cut to this rank's blocks
    (``launch.train.shard_state_``), a prefill of the prompts, then the
    one-rank serve's tokens fed step by step (teacher forcing), each step's
    logits (this rank's vocabulary block, gathered over ``model``) held to
    the one-rank's within ``MESH_LOGIT_TOL`` of its max|logit|."""
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model as tm

    cfg, prompts, tokens = job["cfg"], job["prompts"], job["tokens"]
    mesh = make_mesh(job["shape"], ("data", "model"), device=device)
    params = tm.TransformerParams(job.pop("tensors"))  # views of the parent's weights
    tr.shard_state_(params, None, tr.state_layout("lm", params, mesh), ())
    state_gb = sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9
    model = shd.axis_group(mesh, ("model",))
    reset_peak(device)
    shd.activate(mesh)
    train_counters(zero=True)
    coll.reset_counts()
    sync(device)
    torch.distributed.barrier()
    with flash_heads([]) as heads:
        t0 = time.perf_counter()
        logits, cache = tm.prefill(params, prompts, cfg, capacity=job["capacity"],
                                   full_logits=False)
        sync(device)
        prefill_s = time.perf_counter() - t0
        got = [logits]
        t0 = time.perf_counter()
        for i in range(tokens.shape[1] - 1):
            got.append(tm.decode_step_(params, cache, tokens[:, i:i + 1], cfg))
        sync(device)
        decode_s = time.perf_counter() - t0
    launches = train_counters()
    collectives = coll.reset_counts()
    shd.deactivate()
    errs = []
    for i, (g, want) in enumerate(zip(got, job["logits"])):
        scale = float(want.abs().max())
        err = float((coll.all_gather_dim(g, 1, model).float() - want).abs().max())
        if err > MESH_LOGIT_TOL * scale:
            raise AssertionError(f"mesh tp step {i}: max|Δlogit| {err} > "
                                 f"{MESH_LOGIT_TOL}·{scale}")
        errs.append(err / scale)
    rep = {"prefill_s": prefill_s, "decode_s": decode_s, "launches": launches,
           "flash_heads": heads, "collectives": collectives, "rel_err_per_step": errs,
           "logits_shape": list(got[0].shape), "cache_shape": list(cache["k"].shape),
           "state_gb": state_gb, "peak_gb": peak_gb(device)}
    del params, cache, got
    return rep


def mesh_tp(seed, device, card, reduced=False):
    """h2o-danube-1.8b on the mesh against one rank in this process: the
    one-rank serve of ``MESH_TP_DECODE_STEPS`` steps after 4 × 6,144 prompt
    tokens; on ``MESH_TP_SERVE`` gloo ranks the same serve tensor-parallel
    (:func:`_mesh_tp_serve`: logits within ``MESH_LOGIT_TOL`` a step, the
    flash launches one rank's, ``H/m`` heads each, the cache ``C/m`` slots a
    rank); on each mesh of ``MESH_LM_TRAIN`` the sharded trainer against
    one rank's at 4 × 4,096 tokens (:func:`mesh_train_sharded`, its rank
    step dry-run against the card). Returns the launches over the ranks."""
    from repro_torch import configs
    from repro_torch.launch import serve as srv
    from repro_torch.models.transformer import model as tm

    t0 = time.perf_counter()
    spec = configs.get_spec(MESH_TP_ARCH)
    cfg = spec.reduced if reduced else dataclasses.replace(spec.config, n_layers=CKPT_LAYERS)
    batch, prompt_len = (4, 40) if reduced else (4, 6144)
    params = tm.init(cfg, seed=seed, device=device)
    prompts = srv.random_prompts(cfg, batch, prompt_len, seed + 1, device)
    train_counters(zero=True)
    with flash_heads([]) as heads:
        ref = srv.serve(params, cfg, prompts, MESH_TP_DECODE_STEPS)
    serve_launches = train_counters()
    tensors = {"embed": params.embed.data, "ln_f": params.ln_f.data,
               "layers": {k: v.data for k, v in params.layers.items()}}
    if params.unembed is not None:
        tensors["unembed"] = params.unembed.data
    serve = {"cfg": cfg, "shape": MESH_TP_SERVE, "tensors": tensors, "prompts": prompts,
             "tokens": ref.tokens, "logits": [x.float() for x in ref.logits],
             "capacity": ref.capacity}
    total, runs = mesh_train_sharded(MESH_TP_ARCH, seed, device, card, reduced, MESH_LM_TRAIN,
                                     {MESH_TP_SERVE: serve})
    reports, m = runs[MESH_TP_SERVE], MESH_TP_SERVE[1]
    for r, rep in sorted(reports.items()):
        rep = rep["serve"]
        if device.type == "cuda" and rep["launches"] != serve_launches:
            raise AssertionError(f"mesh tp serve rank {r}: launches {rep['launches']}, "
                                 f"one rank's {serve_launches}")
        if rep["flash_heads"] != [h // m for h in heads]:
            raise AssertionError(f"mesh tp serve rank {r}: flash heads "
                                 f"{rep['flash_heads']}, one rank's {heads} over {m}")
        if rep["cache_shape"][2] * m != ref.capacity:
            raise AssertionError(f"mesh tp serve rank {r}: cache {rep['cache_shape']}, "
                                 f"not {ref.capacity} / {m} slots")
        add_launches(total, rep["launches"])
    say("mesh_tp_serve", card, arch=cfg.name, mesh=dict(zip(("data", "model"), MESH_TP_SERVE)),
        layers=cfg.n_layers, batch=batch, prompt_len=prompt_len,
        decode_steps=MESH_TP_DECODE_STEPS, one_rank_prefill_s=ref.prefill_s,
        one_rank_decode_s=ref.decode_s,
        prefill_s=[rep["serve"]["prefill_s"] for rep in reports.values()],
        decode_s=[rep["serve"]["decode_s"] for rep in reports.values()],
        max_rel_logit_err=max(max(rep["serve"]["rel_err_per_step"])
                              for rep in reports.values()),
        rel_logit_err_rank0=reports[0]["serve"]["rel_err_per_step"], tol=MESH_LOGIT_TOL,
        logits_shape_rank=reports[0]["serve"]["logits_shape"],
        cache_shape_rank=reports[0]["serve"]["cache_shape"],
        flash_heads_per_launch=sorted(set(reports[0]["serve"]["flash_heads"])),
        flash_heads_one_rank=sorted(set(heads)),
        launches_per_rank=reports[0]["serve"]["launches"],
        weights_gb_per_rank=[rep["serve"]["state_gb"] for rep in reports.values()],
        peak_gb_per_rank=[rep["serve"]["peak_gb"] for rep in reports.values()],
        collectives_per_rank=[rep["serve"]["collectives"] for rep in reports.values()],
        transport=MESH_TRANSPORT)
    del params, tensors, serve, ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    say("mesh_phase", card, part="tp", seconds=time.perf_counter() - t0)
    return total



def mesh_tp_probe(seed, device, card):
    """Where the tensor-parallel serve's logit error comes from: the serve
    of :func:`mesh_tp` on ``MESH_TP_SERVE`` gloo ranks against one rank in
    float32 at ``CKPT_LAYERS`` layers, in bfloat16 at one layer and at
    ``CKPT_LAYERS``; a ``mesh_tp_probe`` line each with every step's
    max|Δlogit| / max|logit| (the prefill's first). No result line."""
    from repro_torch import configs
    from repro_torch.launch import serve as srv
    from repro_torch.models.transformer import model as tm

    spec = configs.get_spec(MESH_TP_ARCH)
    for dtype, layers in (("float32", CKPT_LAYERS), ("bfloat16", 1), ("bfloat16", CKPT_LAYERS)):
        cfg = dataclasses.replace(spec.config, n_layers=layers, param_dtype=dtype,
                                  compute_dtype=dtype)
        params = tm.init(cfg, seed=seed, device=device)
        prompts = srv.random_prompts(cfg, 4, 6144, seed + 1, device)
        ref = srv.serve(params, cfg, prompts, MESH_TP_DECODE_STEPS)
        tensors = {"embed": params.embed.data, "ln_f": params.ln_f.data,
                   "layers": {k: v.data for k, v in params.layers.items()}}
        if params.unembed is not None:
            tensors["unembed"] = params.unembed.data
        job = {"kind": "serve", "world": math.prod(MESH_TP_SERVE),
               "serve": {"cfg": cfg, "shape": MESH_TP_SERVE, "tensors": tensors,
                         "prompts": prompts, "tokens": ref.tokens,
                         "logits": [x.float() for x in ref.logits], "capacity": ref.capacity}}
        reports, _ = run_ranks([job], device, target=mesh_rank, world=job["world"],
                               what=f"mesh tp probe {dtype} {layers}")
        say("mesh_tp_probe", card, dtype=dtype, layers=layers,
            rel_logit_err_rank0=reports[0]["rel_err_per_step"],
            max_rel_logit_err=max(max(rep["rel_err_per_step"]) for rep in reports.values()))
        del params, tensors, job, ref
        gc.collect()
        if device.type == "cuda":
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()


# -- 10. the examples and the dry-run against the card ------------------------

#: the dry-run's predicted peak against the card's: within REL · card + ABS GB
#: (PERF.md states it with the measured gaps)
DRY_PEAK_TOL = (0.10, 0.25)
#: every ``dryrun_vs_card`` line of this run
DRY_CELLS = []
#: the archs whose every cell the dry-run phase traces at full width (the
#: CLI's ``--all`` takes minutes: qwen3-moe-235b's train step alone ~4.5)
DRY_FULL_ARCHS = ("h2o-danube-1.8b", "pna", "graphsage-reddit", "graphcast", "gat-cora",
                  "autoint")
#: the archs whose every cell the dry-run phase also traces as rank 0 of
#: the JAX package's pod meshes (``single``, ``multi``; the CLI's
#: ``--mesh both`` traces all 40 cells on each)
DRY_POD_ARCHS = ("h2o-danube-1.8b", "gat-cora", "autoint")
#: single cells the dry-run phase also traces on both pod meshes, each
#: required to fit the card: GraphCast's largest, its graph split over
#: every rank
DRY_POD_CELLS = (("graphcast", "ogb_products"),)


def dry_vs_card(cell, fn, args, device, card, model_flops=None):
    """Dry-runs ``fn(*args)`` (``launch.dryrun.trace`` on fake twins of
    ``args``), then runs it twice for real: the first run's launches per
    route and its peak — ``max_memory_allocated`` after a reset, less what
    was allocated before the step, plus the step's arguments as the dry-run
    counts them — the second run's time. Prints a ``dryrun_vs_card`` line
    with the predicted and the card's launches, peak GB, the predicted step
    lower bound beside the warm time and ``mfu`` = model flops ÷ (warm s ×
    989 TFLOP/s). Fails unless the launches are equal and the peak within
    ``DRY_PEAK_TOL``. On the CPU (a rehearsal) it prints the dry-run alone:
    there the wrappers take their plain versions."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import HW

    hw = HW.from_card() if device.type == "cuda" else HW()
    rec = dryrun.trace(fn, dryrun.fake_like(args), hw, 1, model_flops)
    mem, roof = rec["memory"], rec["roofline"]
    line = {"cell": cell, "launches_dry": rec["launches"],
            "peak_gb_pred": mem["peak_per_device_bytes"] / 1e9,
            "argument_gb": mem["argument_bytes"] / 1e9,
            "step_lower_bound_s": roof["step_lower_bound_s"], "bottleneck": roof["bottleneck"],
            "flops_pred": rec["cost"]["flops_per_device"],
            "bytes_pred": rec["cost"]["bytes_per_device"], "model_flops": model_flops,
            "trace_s": rec["trace_s"]}
    if device.type != "cuda":
        say("dryrun_vs_card", card, **line, rehearsal=True)
        return line
    gc.collect()
    sync(device)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts = dryrun.launch_counts()
    fn(*args)
    sync(device)
    launches = dryrun.launches_between(counts, dryrun.launch_counts())
    raw_peak = torch.cuda.max_memory_allocated()
    peak = raw_peak - before + mem["argument_bytes"]
    t0 = time.perf_counter()
    fn(*args)
    sync(device)
    warm_s = time.perf_counter() - t0
    rel, abs_gb = DRY_PEAK_TOL
    within = abs(mem["peak_per_device_bytes"] - peak) <= rel * peak + abs_gb * 1e9
    line.update(launches_card=launches, launches_equal=launches == rec["launches"],
                peak_gb_card=peak / 1e9, max_memory_allocated_gb=raw_peak / 1e9,
                allocated_before_gb=before / 1e9, peak_tol=list(DRY_PEAK_TOL),
                peak_within_tol=within, warm_s=warm_s,
                mfu=None if model_flops is None else model_flops / (warm_s * hw.peak_flops))
    say("dryrun_vs_card", card, **line)
    DRY_CELLS.append(line)
    if launches != rec["launches"]:
        raise AssertionError(f"dry-run {cell}: launches {rec['launches']}, card {launches}")
    if not within:
        raise AssertionError(f"dry-run {cell}: peak {mem['peak_per_device_bytes'] / 1e9} GB "
                             f"predicted, {peak / 1e9} GB on the card")
    return line


def lm_shape(kind, seq_len, batch):
    return {"kind": kind, "seq_len": seq_len, "global_batch": batch}


def lm_dry_vs_card(params, cfg, prompts, res, prompt_len, steps, batch, device, card):
    """:func:`dry_vs_card` of the served LM's prefill and of one decode step
    on its cache (the step writes the cache in place, as JAX's donates it)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import model as tm

    def prefill(p, t):
        return tm.prefill(p, t, cfg, capacity=res.capacity, full_logits=False)

    def decode(p, c, t):
        return tm.decode_step_(p, c, t, cfg), c

    dry_vs_card(f"{cfg.name} prefill", prefill, (params, prompts), device, card,
                dryrun.lm_model_flops(cfg, lm_shape("prefill", prompt_len, batch)))
    _, cache = prefill(params, prompts)
    dry_vs_card(f"{cfg.name} decode step", decode,
                (params, cache, res.tokens[:, :1].contiguous()), device, card,
                dryrun.lm_model_flops(cfg, lm_shape("decode", prompt_len + steps, batch)))


def block_graph(batch_nodes, fanouts):
    """A sampled minibatch's seeds and two hops as one block graph."""
    from repro_torch.launch import dryrun

    return dryrun.gnn_graph_size({"kind": "minibatch", "batch_nodes": batch_nodes,
                                  "fanouts": tuple(fanouts)})


def check_flash_route_rule():
    """``flash_attention``'s Python route rule (``ops.route``, ``ops.bwd_route``:
    the dry-run's fake route takes it) against the built libraries' own
    (``flash_attention_uses_tc``, ``flash_attention_bwd_uses_tc``), for
    every D of 1..128 in f32 and bf16; returns the cases."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops

    fwd = build.library("flash_attention").flash_attention_uses_tc
    bwd = build.library("flash_attention_bwd").flash_attention_bwd_uses_tc
    for fn in (fwd, bwd):
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    cases = 0
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in range(1, 129):
            if (ops.route(dtype, d) == "tc") != bool(fwd(code, d)) or \
                    (ops.bwd_route(dtype, d) == "tc") != bool(bwd(code, d)):
                raise AssertionError(f"flash route rule: Python and library differ at "
                                     f"{dtype}, D = {d}")
            cases += 1
    return cases


def examples_phase(device, card):
    """The four ``examples/torch_*.py`` on the card through the functions
    they expose, each one's own assertions held (the interpreter oracle,
    S-V equal across fused/pull/naive, the trained accuracy past 0.8); one
    ``example`` line each with its seconds and launches per route."""
    import importlib.util

    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import model as tm

    def load(name):
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def serve_lm(mod):
        cfg = mod.config()
        prompts = torch.randint(0, cfg.vocab_size, (4, 64),
                                generator=torch.Generator().manual_seed(1)).to(torch.int32)
        res = mod.serve(tm.init(cfg, seed=0, device=device), cfg, prompts.to(device), 32)
        if tuple(res["tokens"].shape) != (4, 33) or res["capacity"] != 32:
            raise AssertionError(f"serve_lm: tokens {tuple(res['tokens'].shape)}, "
                                 f"capacity {res['capacity']}")
        return {"prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
                "first_stream": res["tokens"][0, :8].tolist()}

    runs = {
        "torch_quickstart": lambda m: {"trips": m.run(device)["trips"]},
        "torch_connected_components": lambda m: {
            k if k == "trips" else f"regime_{k}": v for k, v in m.run(device).items()
            if k in ("trips", "seconds")},
        "torch_gnn_cora": lambda m: {"accs": m.train(device, log=lambda line: None)["accs"]},
        "torch_serve_lm": serve_lm,
    }
    t_phase = time.perf_counter()
    for name, run in runs.items():
        counts = dryrun.launch_counts()
        t0 = time.perf_counter()
        out = run(load(name))
        sync(device)
        say("example", card, name=name, ok=True, seconds=time.perf_counter() - t0,
            launches=dryrun.launches_between(counts, dryrun.launch_counts()), **out)
    say("examples_phase", card, seconds=time.perf_counter() - t_phase)


def dryrun_rehearsal(seed, device, card, lm_batch, prompt_len, decode_steps):
    """``--dryrun-only``: the examples, then :func:`dry_vs_card` on the
    h2o-danube-1.8b serve, gat-cora's forward on a scale-18 R-MAT, AutoInt's
    serve cells and three trainers (h2o-danube, gat-cora, AutoInt), then
    :func:`dryrun_phase`."""
    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPE_CLASSES
    from repro_torch.data import gnn_full_batch

    examples_phase(device, card)
    lm_path(configs.get_spec("h2o-danube-1.8b").config, lm_batch, prompt_len, decode_steps,
            seed, device, card)
    torch.cuda.empty_cache()
    spec = configs.get_spec("gat-cora")
    cfg = configs.resolve_gnn_config(spec.config, "ogb_products", spec.shapes["ogb_products"])
    batch = gnn_full_batch(2**18, GNN_AVG_DEGREE["ogb_products"], cfg.d_in,
                           GNN_SHAPE_CLASSES["ogb_products"], seed=seed, device=device)
    gnn_serve("gat-cora", cfg, batch, seed, device, card)
    del batch
    spec = configs.get_spec("autoint")
    autoint_path(spec.config, spec.shapes, seed, device, card)
    torch.cuda.empty_cache()
    train_path(None, seed, device, card)
    torch.cuda.empty_cache()
    dryrun_phase(device, card)


def dry_cell(arch, shape_id, mesh, device, hw, card) -> bool:
    """One cell dry-run at full width on ``mesh`` (``launch.dryrun.
    dryrun_cell``) with a ``dryrun_cell`` line; fails if it fails, or if a
    cell of ``DRY_POD_CELLS`` does not fit a rank of a pod mesh. Whether it
    ran (a skipped cell did not)."""
    from repro_torch.launch import dryrun

    rec = dryrun.dryrun_cell(arch, shape_id, mesh, device.type, hw)
    if rec["status"] == "failed":
        raise AssertionError(f"dry-run {arch} {shape_id} {mesh}: {rec['error']}")
    if rec["status"] != "ok":
        return False
    say("dryrun_cell", card, arch=arch, shape=shape_id, mesh=mesh,
        n_devices=rec["n_devices"], fits=rec["memory"]["fits"],
        peak_gb=rec["memory"]["peak_per_device_bytes"] / 1e9,
        collective_gb=rec["collectives"]["total"] / 1e9,
        bottleneck=rec["roofline"]["bottleneck"],
        step_lower_bound_s=rec["roofline"]["step_lower_bound_s"],
        launches=rec["launches"], trace_s=rec["trace_s"])
    if mesh != "card" and (arch, shape_id) in DRY_POD_CELLS and not rec["memory"]["fits"]:
        raise AssertionError(f"dry-run {arch} {shape_id} {mesh}: a rank's peak "
                             f"{rec['memory']['peak_per_device_bytes'] / 1e9} GB")
    return True


def dryrun_phase(device, card):
    """The flash route rule against the library, then every cell of
    ``DRY_FULL_ARCHS`` dry-run at full width on fake CUDA tensors (fits,
    peak GB, bottleneck), those of ``DRY_POD_ARCHS`` again as rank 0 of
    the pod meshes (peak and collective GB a rank), and a summary of this
    run's ``dryrun_vs_card`` cells."""
    from repro_torch import configs
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    say("flash_route_rule", card, ok=True, cases=check_flash_route_rule(),
        versus="flash_attention_uses_tc, flash_attention_bwd_uses_tc")
    hw = dryrun.default_hw(device.type)
    n_ok = 0
    cells = [(arch, shape_id, "card") for arch in DRY_FULL_ARCHS
             for shape_id in configs.get_spec(arch).shapes] + [
        (arch, shape_id, mesh) for mesh in ("single", "multi") for arch in DRY_POD_ARCHS
        for shape_id in configs.get_spec(arch).shapes] + [
        (arch, shape_id, mesh) for mesh in ("single", "multi")
        for arch, shape_id in DRY_POD_CELLS]
    for arch, shape_id, mesh in cells:
        n_ok += dry_cell(arch, shape_id, mesh, device, hw, card)
    say("dryrun_phase", card, seconds=time.perf_counter() - t_phase, full_width_ok=n_ok,
        hbm_gb=hw.hbm_bytes / 1e9, vs_card_cells=len(DRY_CELLS),
        vs_card_launches_equal=all(c["launches_equal"] for c in DRY_CELLS),
        vs_card_peak_within_tol=all(c["peak_within_tol"] for c in DRY_CELLS))


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
    if "--flash-index-hash" in sys.argv[1:]:
        return flash_index_hash(seed, card)
    def timed_build():
        t0 = time.perf_counter()
        return build.build(), time.perf_counter() - t0

    # the whole run builds the main path's graphs on the host while nvcc runs
    whole_run = not any(a.startswith("--") for a in sys.argv[1:])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(timed_build)
        graphs = main_graphs(scale, edgefactor, seed, device, card) if whole_run else None
        reports, build_s = pending.result()
    say("build", card, seconds=build_s, built=sorted(reports))
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
        _, routes, _, _ = gnn_path(device, card, mesh=False)
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
    if "--positions" in sys.argv[1:]:  # the flash positions route alone: no result line
        positions_phase(seed, device, card)
        return 0
    if "--positions-profile" in sys.argv[1:]:  # its launches' device times: no result line
        return positions_profile(seed, device, card)
    if "--row-gemm" in sys.argv[1:]:  # row blocks of the GNN products: no result line
        row_gemm_probe(device, card)
        return 0
    if "--mesh-probe" in sys.argv[1:]:  # GraphCast's mesh error by layer: no result line
        mesh_probe(seed, device, card)
        return 0
    if "--mesh-gnn" in sys.argv[1:]:  # the GNNs on the mesh alone: no result line
        gnn_path(device, card, only_mesh=True)
        torch.cuda.empty_cache()
        mesh_train_gat(seed, device, card)
        from repro_torch.launch import dryrun

        hw = dryrun.default_hw(device.type)
        for mesh in ("single", "multi"):
            for arch, shape_id in DRY_POD_CELLS:
                dry_cell(arch, shape_id, mesh, device, hw, card)
        return 0
    if "--mesh-only" in sys.argv[1:]:  # the mesh phase alone: no result line
        gnn_path(device, card, only_mesh=True)
        torch.cuda.empty_cache()
        mesh_moe(configs.get_spec("deepseek-moe-16b").config, lm_batch, prompt_len,
                 decode_steps, seed, device, card)
        torch.cuda.empty_cache()
        mesh_train(seed, device, card)
        torch.cuda.empty_cache()
        mesh_tp(seed, device, card)
        return 0
    if "--mesh-tp" in sys.argv[1:]:  # the dense LM on the mesh alone: no result line
        mesh_tp(seed, device, card)
        return 0
    if "--mesh-tp-probe" in sys.argv[1:]:  # the TP serve's error by dtype, depth: no result
        mesh_tp_probe(seed, device, card)
        return 0
    if "--mesh-moe" in sys.argv[1:]:  # the MoE LM on the mesh alone: no result line
        mesh_moe(configs.get_spec("deepseek-moe-16b").config, lm_batch, prompt_len,
                 decode_steps, seed, device, card)
        return 0
    if "--mesh-moe-probe" in sys.argv[1:]:  # the MoE serve's mesh error by dtype, depth
        mesh_moe_probe(seed, device, card)
        return 0
    if "--ckpt-drill" in sys.argv[1:]:  # the checkpoint drill alone: no result line
        ckpt_drill(seed, device, card)
        return 0
    if "--dryrun-only" in sys.argv[1:]:  # the examples and the dry-run: no result line
        dryrun_rehearsal(seed, device, card, lm_batch, prompt_len, decode_steps)
        return 0
    if "--train-only" in sys.argv[1:]:  # a rehearsal of the training phase: no result line
        cases, ratio = check_backward_kernels(device, gen)
        say("backward_check", card, ok=True, cases=cases, flash_bwd_max_row_ratio=ratio,
            versus="plain PyTorch versions")
        launches = train_path(minibatch_graph(device, card, seed), seed, device, card)
        for row in train_kernel_rows(launches, seed, device, card):
            say("train_kernel", card, **row)
        return 0
    cases, row_ratio = check_kernels(device, gen)
    say("kernel_check", card, ok=True, cases=cases, flash_max_row_ratio=row_ratio,
        versus="plain PyTorch versions")

    launches, graphs, replicated = main_path(scale, edgefactor, seed, device, card, graphs)
    partitioned = partitioned_path(graphs, replicated, device, card)
    rows = kernel_rows(graphs, launches, partitioned)
    busy_share(graphs[0], replicated[2]["result"].supersteps, card)
    say("memory", card, path="graph",
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del graphs, replicated

    if "--graph-only" in sys.argv[1:]:  # a rehearsal of the graph kernels: stop here
        return finish(rows, card, t_start)
    torch.cuda.empty_cache()
    gnn_launches, routes, minibatch, mesh_launches = gnn_path(device, card)
    minibatch = park(minibatch, torch.device("cpu"))
    for row in rows:  # the GNN phase's launches and wide-route times
        row["launches_gnn"] = {k[len(row["name"]) + 1:] or "all": v
                               for k, v in gnn_launches.items() if k.startswith(row["name"])}
        row["gnn_routes"] = {k: v for k, v in routes.items() if v["kernel"] == row["name"]}
    say("memory", card, path="gnn", allocated_after_gb=torch.cuda.memory_allocated() / 1e9)
    lm = lm_path(configs.get_spec("h2o-danube-1.8b").config, lm_batch, prompt_len,
                 decode_steps, seed, device, card)
    torch.cuda.empty_cache()
    moe_one_rank = {}
    rows += moe_path(configs.get_spec("deepseek-moe-16b").config, lm_batch, prompt_len,
                     decode_steps, seed, device, card, one_rank=moe_one_rank)
    torch.cuda.empty_cache()
    add_launches(mesh_launches, mesh_moe(configs.get_spec("deepseek-moe-16b").config,
                                         lm_batch, prompt_len, decode_steps, seed, device,
                                         card, one_rank=moe_one_rank))
    moe_one_rank.clear()
    torch.cuda.empty_cache()
    spec = configs.get_spec("autoint")
    rec = autoint_path(spec.config, spec.shapes, seed, device, card)
    rows += model_kernel_rows(lm, rec)
    del rec
    torch.cuda.empty_cache()
    cases, ratio = check_backward_kernels(device, gen)
    say("backward_check", card, ok=True, cases=cases, flash_bwd_max_row_ratio=ratio,
        versus="plain PyTorch versions")
    rows += positions_phase(seed, device, card)
    torch.cuda.empty_cache()
    launches = train_path(park(minibatch, device), seed, device, card)
    del minibatch
    torch.cuda.empty_cache()
    add_launches(mesh_launches, mesh_train(seed, device, card))
    torch.cuda.empty_cache()
    add_launches(mesh_launches, mesh_tp(seed, device, card))
    torch.cuda.empty_cache()
    drill = ckpt_drill(seed, device, card)
    torch.cuda.empty_cache()
    rows += train_kernel_rows(launches, seed, device, card)
    for name in ("flash_attention", "flash_attention_bwd"):  # the drill's launches
        row = next(r for r in rows if r["name"] == name and "path" not in r)
        row["launches_ckpt_drill"] = drill[name]
    torch.cuda.empty_cache()
    examples_phase(device, card)
    dryrun_phase(device, card)
    names = {r["name"] for r in rows}
    for name in names:  # the mesh phase's launches, over its ranks
        row = next((r for r in rows if r["name"] == name and "path" not in r), None)
        if row is None:
            continue
        row["launches_mesh"] = {
            k[len(name) + 1:] or "all": v for k, v in mesh_launches.items()
            if max((n for n in names if k == n or k.startswith(n + "_")), key=len,
                   default=None) == name}
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


#: ``--flash-index-hash``'s cases: (B, H, Hkv, S, D, dtype, causal, window,
#: round_scores) — the two prefills' shapes, then small ones over both
#: routes, D % 16 != 0, a window without causal
INDEX_HASH_CASES = [
    (4, 32, 8, 6144, 80, torch.bfloat16, True, 4096, True),
    (4, 16, 16, 6144, 128, torch.bfloat16, True, None, True),
    (2, 4, 2, 700, 80, torch.bfloat16, True, 300, True),
    (2, 4, 2, 300, 40, torch.float32, True, 100, False),
    (1, 2, 1, 333, 80, torch.bfloat16, False, 50, False),
    (1, 2, 2, 257, 8, torch.bfloat16, True, None, True),
]


def flash_index_hash(seed, card) -> int:
    """``--flash-index-hash [--against FILE]``: builds the two flash
    libraries and runs their index route (the forward with its lse, the
    backward) on ``INDEX_HASH_CASES`` from seeded inputs, printing a
    ``flash_index_hash`` line with a SHA-256 of every output's bits; with
    ``--against FILE`` (another run's output) it also says, tensor by
    tensor, whether the bits are equal. It calls only the wrappers'
    index-route arguments, so a copy of this script beside an earlier
    tree of the port hashes that tree's kernels: the index route bit for
    bit across two trees. No result line."""
    import hashlib

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fl

    build.build(["flash_attention", "flash_attention_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hashes = {}
    for i, (b, h, hkv, s, d, dt, causal, window, rnd) in enumerate(INDEX_HASH_CASES):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                       for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                                     (b, h, s, d)))
        out, lse = fl.flash_attention(q, k, v, causal, window, d**-0.5, return_lse=True,
                                      round_scores=rnd)
        grads = fl.flash_attention_bwd(q, k, v, out, lse, do, causal, window, d**-0.5, rnd)
        for name, t in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads)):
            bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
            hashes[f"{i}/{name}"] = hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()
    line = {"cases": len(INDEX_HASH_CASES), "sha256": hashes}
    if "--against" in sys.argv[1:]:
        other = Path(sys.argv[sys.argv.index("--against") + 1]).read_text()
        theirs = json.loads(other.split("flash_index_hash ", 1)[1].splitlines()[0])["sha256"]
        line["equal"] = {k: theirs.get(k) == v for k, v in hashes.items()}
        line["all_equal"] = all(line["equal"].values())
    say("flash_index_hash", card, **line)
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
