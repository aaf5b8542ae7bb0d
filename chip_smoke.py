"""Drive the PyTorch port on one NVIDIA card and check what comes out.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit; nothing is caught
and carried on from):

1. Environment: torch/CUDA versions, the card's name and power limit, the
   TF32 settings (off), and the build of the kernels from
   ``pytorch_ps_mpi_tpu_torch/csrc`` — one ``nvcc`` per source, run
   together — with ``nvcc``'s register report; then the native host
   library the CLI's checkpoints and loader use (``g++``).
2. Each kernel against its plain PyTorch version on the card:
   * the codec kernels bitwise, at the 62 ResNet-18 parameter sizes (world
     1 and 4, bits 8 and 16, bf16, f16 and f32 wires, an all-zero tile, a
     NaN tile, ragged tails, unaligned and strided inputs; the decode sums
     as groups of one), and ``block_quantize``'s clusters: a tile for each
     cluster size, a tile whose max lies in the last CTA of its cluster, a
     NaN outside rank 0 and a zero tile inside an 8-CTA cluster;
   * the grouped decode sums against the per-leaf plain versions: the 62
     ResNet-18 leaves, the 150 LM leaves and a mixed group, each as one
     group laid out as the step gathers it (shared buckets with leaves at
     odd offsets, solo leaves, tiles of 8 to 512 rows), at worlds 1 and 4,
     bits 8 and 16, bf16, f16 and f32 wires, with their launch counts, and
     a group long enough to be split across launches;
   * the overlap engine's fused buckets: the 12 buckets of the ResNet-18
     plan, each quantized as one tensor (tiles straddling its leaves), and
     one grouped decode over the 12, at worlds 1 and 4, all bitwise;
   * the flash attention kernels within stated tolerances, at the LM's
     main-path shape (strided q/k/v views, causal, bf16), D = 128, a ragged
     S, non-causal, a scale override, f32, odd head dims and the edges of
     the bf16 kernels' 128-row blocks and the serve tier's decode shape,
     each output also against an f32 dense reference, and how the three
     bf16 flash kernels occupy the card
     (registers, shared memory, blocks per SM; a spill fails the run);
   then each timed at the main path's shapes beside its plain version, a
   library call where one computes the same function, and its bound (the
   decode sums: device time of one grouped launch over the 62 ResNet-18
   leaves from a CUDA graph, and the call's host time), ``flash_fwd`` also
   at the serve tier's decode shape ``[4, 1024, 16, 64]``, and
   ``block_quantize`` also alone on the largest ResNet-18 gradient, it and
   the decode sums on the LM's embedding (device time from a CUDA graph of
   back-to-back launches).
3. The ResNet slice through its public entry points: a one-rank NCCL
   group, full-width bf16 ResNet-18 and ``SGD(lr=0.1, momentum=0.9)`` on
   synthetic CIFAR-10 at batch 1024 — 3 warm-up and 10 timed steps with the
   blockq codec; the same through the overlap engine with the fused
   per-bucket encode (``sync_mode="overlap", fused_encode=True``: 12
   ``block_quantize`` launches a step), timed again in turns with the
   bucketed run, 7 steps unfused (62) and 2 bf16 steps; then 3
   steps each with bf16 and identity — with the kernels' launch counts
   read around each run, a profile of two steps of each blockq run and of
   bf16 (device time by kernel category, busy share); with cuDNN's
   deterministic algorithms, two steps of bucketed identity twice (the
   card's run-to-run difference), of the overlap engine's identity with
   each reducer, and of bucketed and fused overlap blockq with and without
   ``profile=True`` (the phase split), each held to that difference; and a
   small MLP run on the card, bucketed and fused overlap blockq, checked
   against the same runs on the CPU (plain versions).
   Then the step's features on the same model: the kernels a step of the
   bucketed and fused blockq runs beside those before the element-order
   repair (the repair: each order-dependent codec encodes in the JAX package's
   layout); the topk (1%), topk_approx, quantize and sign codecs (losses
   finite and falling, ``packaged_bytes`` the sum of ``wire_bytes``, and
   the small MLP card vs CPU with each); blockq with error feedback (62
   ``block_quantize`` and 2 ``block_dequant_sum`` launches a step), ZeRO
   with the identity codec and with blockq, bf16 with ZeRO and EMA (one
   ``cast_sum`` a step) and the consensus guard every 2 steps; and a ``state_dict`` round trip (3 steps, a fresh
   optimizer loads the state, 2 more) against 5 steps in one run, cuDNN
   deterministic, to a difference of 0.0.
4. The transformer LM of the repo's LM benchmark at full width and depth
   (219,346,944 parameters, bf16, flash attention, batch 16 x 1024 tokens)
   with ``SGD(lr=0.01, momentum=0.9)``: 2 warm-up and 5 timed identity
   steps (tokens/s, flash launches per step, wire bytes), a profile of two
   steps, 2 warm-up and 3 timed identity steps through the overlap engine,
   2 blockq steps, the consensus guard's time on the 219M parameters,
   3 steps with ``accum_steps=4, remat=True`` (flash_fwd 96 launches a
   step, each backward kernel 48; peak memory against the plain step's;
   a profile of one step), the f32 lm_head GEMMs timed alone, and a small
   f32 LM run on the card checked against the same run on the CPU.
5. The training CLI (`pytorch_ps_mpi_tpu_torch.train`) on the card, through
   its entry point: in processes of their own (TF32 off, as here; the
   console entry ``cli_entry``), 20 steps of ResNet-18 bf16 blockq at
   batch 1024 (the ``done:`` line's images/s beside phase 3's bucketed
   figure, losses finite and falling) and 10 steps of the CLI's LM (bf16,
   flash attention, batch 16 x 1024: tokens/s); in this process, with the
   launch counts read around each run, 3 ResNet-18 steps (62
   ``block_quantize`` and 1 ``block_dequant_sum`` a step), 6 steps of
   ResNet-50 at full ImageNet width, batch 256 (161 ``block_quantize`` a
   step, finite losses, images/s and peak memory), one bf16 step of LeNet
   (1 ``cast_sum``) and 2 LM steps (4 launches of each flash kernel a
   step).  Then, under cuDNN's deterministic algorithms, a ResNet-18 run
   preempted by a real SIGTERM (exit 75, a RESUMABLE step-tagged
   checkpoint) and resumed, against a straight run: params and momentum
   equal to 0.0, with ``save_optimizer``/``load_optimizer`` timed and the
   file's size; the divergence guard rolling back once on an injected
   loss spike (the MLP, batch 1024); and the CLI's MLP with blockq on the
   card against ``--force-cpu-devices 1``.
6. The in-process async PS (`AsyncSGD`: worker threads on CUDA streams of
   the one card), after the JAX bench's ``worker_async_resnet18``:
   ResNet-18 bf16 (BatchNorm in evaluation mode on its initial
   statistics), batch 512, synthetic CIFAR-10 of 8,192 examples, lr 0.02,
   momentum 0.9, 4 warm-up and 40 timed updates — (1) one worker sharing
   the card with the PS, quota 1, identity, bf16 (staleness-weighted:
   the weights scale the bf16 wire, one ``cast_sum`` a fill) and blockq
   (62 ``block_quantize`` a gradient, one ``block_dequant_sum`` a fill); (2) a
   PS and four worker threads, quota 4, blockq (images/s beside run 1's,
   staleness, the card's busy share under the profiler); (3) the same
   four workers with a sign-flipping rank 0 under ``trimmed_mean``
   (``trim_k=1``), ``median`` and ``norm_clip`` (4 per-contribution
   decodes a fill); (4) the CLI's async LM (``--async-ps``, bf16, flash,
   blockq, batch 16 x 1024) in a process of its own, saved at update 10,
   resumed here (from the saved params to 0.0, then to update 12 with 4
   launches of each flash kernel a gradient); (5) a lockstep single
   worker on the small MLP (identity, staleness-weighted bf16, blockq),
   card against CPU.  Every async run: finite
   params, a falling loss, the launch counts read around it.
7. The multihost async PS over loopback TCP (`AsyncSGDServer` and
   `AsyncPSWorker`, the JAX package's v12 frames), worker processes on
   the one card: (1) run 6's ResNet-18 cells with the PS in this process
   and the workers as processes of their own (``chip_smoke.py
   --mh-worker``) — one worker at quota 1 and four at quota 4, blockq —
   with images/s, staleness, the PS's phases a update, the wire bytes a
   update and nvidia-smi's utilization beside phase 6's thread figures,
   one ``block_dequant_sum`` a fill on the PS and 62 ``block_quantize`` a
   gradient in each worker; (2) the CLI (``--serve 0`` and two
   ``--connect`` processes) with its LM, bf16 parameter wire, killed
   before update 5 and relaunched with ``--resume`` (the workers
   reconnect; 10 updates, continuous versions; 4 launches of each flash
   kernel a gradient in each worker); (3) a lockstep worker through the
   wire on the small MLP, card against CPU.
8. The bucket-streamed gradient (the v11 GRAD stream): run 1's one-worker
   cell with each gradient in 4 MiB buckets, encoded inside backward (8a)
   and after it (8b), beside run 1a's images/s — every bucket sent is
   assembled on the PS, none is left partial, one fused encode a gradient
   in 8a, 62 ``block_quantize`` a gradient in the worker and one
   ``block_dequant_sum`` a fill on the PS; and the lockstep MLP through
   the wire in fused buckets, card against CPU.
9. The CLI's LM with a dense MoE of 8 experts (capacity factor 1.25):
   (a) the sync CLI, blockq, 10 steps; (b) a PS and 2 worker threads,
   quota 2, 10 updates; (c) ``--serve 0`` and two ``--connect`` workers
   streaming 1 MiB fused buckets — 4 launches of each flash kernel and a
   ``block_quantize`` a leaf per step or gradient, tokens/s.
   Beside phase 3: the reference's nonblocking collectives (``iallgather``,
   ``igather``, ``ibroadcast``, ``ialltoall``, ``ireduce``) at NCCL world
   1 against their definitions, and topk's selection on tied bf16 leaves,
   the card against the CPU.
10. The serve tier on a single PS: (a) an `AsyncSGDServer` on the card
    holding the bench LM (bf16 parameter wire, delta snapshots), one
    worker process pushing blockq gradients with flash attention for 6
    updates, and here a `Subscriber(nonblock_heal=True)` feeding an
    `InferenceFrontend` over the same LM with the flash kernel (4 slots,
    a 1,024-token buffer, 32 requests of 8 tokens with prompts of 8-512
    tokens, one each 0.2 s once training publishes, then drained):
    p50/p95 request latency, generated tokens/s, decode steps and a
    step's time, the hot swaps (the card's parameters bitwise the
    reader's tree, the reader's bitwise the server's post-decode tree),
    the read and delta counters, a full snapshot's and a delta's bytes,
    a snapshot's read and its copy to the card; 12 ``flash_fwd`` a decode
    step, 150 ``block_quantize`` a gradient in the worker and one
    ``block_dequant_sum`` a fill on the PS; the front-end on a small f32
    LM, the card's tokens against the CPU's under the 1e-4 top-2 margin
    rule; (b) the CLI: ``--serve 0 --wire-codec bf16 --delta-parm`` with
    the CLI's LM, two ``--connect`` workers, then a ``--subscribe
    --infer-serve`` reader and a plain ``--subscribe``, their lines
    printed.
11. The sharded PS fleet (`shard.PSFleet`, its K shards and hot standbys
    threads of this process, `shard.ShardRouter` workers processes of
    their own): (a) run 7's ResNet-18 cell on a 2-shard fleet
    (size-balanced greedy, quota 1 a shard) with one router process:
    images/s beside run 1a's in this call, each shard's leaves, bytes,
    updates, PARM and GRAD bytes and staleness; 62 ``block_quantize`` a
    gradient in the router and one ``block_dequant_sum`` a fill on each
    shard; (b) (a) with a hot standby a shard, replication every update,
    admission bounded at staleness 2, shard 1 killed before update 20:
    one promotion with zero rewind, the
    successor's state bitwise the replicated blob and the dead primary's,
    the router keeps its rank, losses finite and falling over the 40
    timed updates, the launch counts going on on the successor;
    ``repl_sent``, ``repl_lag``, a REPL round trip's ms and the gap
    around the promotion; (c) the CLI: ``--serve 0 --shards 2 --replicas
    1 --snapshot-every 5 --save`` with its LM, a ``--subscribe
    h:p0,h:p1 --infer-serve`` reader and two ``--connect h:p0,h:p1``
    workers, then ``--resume`` from the manifest (the versions go on);
    (d) a lockstep MLP through a 2-shard fleet, card against CPU.
12. The two-level hierarchy (`shard.Hierarchy`: the root and its group
    aggregators threads of this process, the workers processes of their
    own): (a) run 1b's ResNet-18 cell with 4 worker processes in 2 groups
    of 2 behind 2 aggregators (group size 2, mean) and the root at quota
    2: images/s beside run 1b's in this call, the root's AGGR bytes an
    update beside run 1b's GRAD bytes, staleness, the groups view; 62
    ``block_quantize`` a gradient in each worker, one
    ``block_dequant_sum`` and 62 ``block_quantize`` a group fill and one
    ``block_dequant_sum`` a root fill in this process, one AGGR frame from
    each aggregator in every root fill; (b) (a) with group 0's aggregator
    killed before its fill 10 and restarted on its port: one restart,
    the upstream rank and the workers' local ranks kept, no duplicate at
    the root, the launch counts going on, the gap around the restart;
    (c) the CLI: ``--serve 0 --shards 2 --aggregators 2 --group-size 1``
    with its LM and two ``--connect <aggregator> --group g --fallback
    <roots>`` workers, their lines and the fleet's groups entry; (d) a
    lockstep MLP through a one-group hierarchy, card against CPU.
13. The multi-rank LM paths over a named mesh, each on the one card with
    every axis of size 1 (NCCL groups of one rank: NCCL takes no two ranks
    of one communicator on one device, so degrees 2 and 4 are held by the
    CPU tests' gloo worlds), through the public API at full width, blockq,
    ``SGD(lr=0.01, momentum=0.9)``, 2 warm-up and 3 timed steps each,
    beside a plain blockq step of the bench LM without a mesh and phase
    4's identity step: (a) tp, the bench LM with ``tp_axis="tp"`` on
    ``make_dp_tp_mesh(1, 1)``; (b) sp, Ulysses over the flash kernels
    with ``batch_spec=("ps", "sp")``; (c) sp, the ring (no flash kernel);
    (d) pp, `make_pipelined_lm_loss` with 4 microbatches (48 launches of
    each flash kernel a step); (e) ep, the CLI's MoE LM (8 experts) over
    ``axis=("ps", "ep")`` — each with its launch counts read around the
    run, finite and falling losses, the first step's loss against the
    dense model's on the same weights and batch, ms/step, tokens/s and
    peak memory; (f) a small f32 LM at each configuration, card against
    CPU (gloo groups).
14. The card line, one JSON line per the kernels, and the last line
    ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SOURCE = "pytorch_ps_mpi_tpu_torch/csrc/codec_kernels.cu"
REPLACES = {
    "block_quantize": "pytorch_ps_mpi_tpu/ops/pallas_kernels.py:91",
    "block_dequant_sum": "pytorch_ps_mpi_tpu/ops/pallas_kernels.py:162",
    "cast_sum": "pytorch_ps_mpi_tpu/ops/pallas_kernels.py:227",
}
FLASH_SOURCE = "pytorch_ps_mpi_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "pytorch_ps_mpi_tpu/ops/flash_attention.py:134",
    "flash_bwd_dkdv": "pytorch_ps_mpi_tpu/ops/flash_attention.py:318",
    "flash_bwd_dq": "pytorch_ps_mpi_tpu/ops/flash_attention.py:344",
}
BATCH = 1024
WARM, TIMED, SIDE = 3, 10, 3
# The overlap engine's runs: the unfused side run's warm and timed steps,
# and the steps of each run the identity and profile comparisons make.
OVERLAP_SIDE, OVERLAP_SIDE_TIMED, COMPARE_STEPS = 2, 5, 2
OVERLAP_BUCKET_BYTES = 4 << 20  # the step's default bucket_mb=4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
        return torch.equal(a.contiguous().view(ints),
                           b.contiguous().view(ints))
    return torch.equal(a, b)


def abs_err(a, b) -> float:
    import torch

    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean time of ``fn()`` on the card, from CUDA events after warm-up."""
    import torch

    for _ in range(warm):
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


def time_graph_ms(fn, calls: int, reps: int = 20) -> float:
    """Device time of one of the ``calls`` launches that ``fn()`` makes:
    ``reps`` calls of ``fn`` captured in a CUDA graph and replayed, CUDA
    events around the replays, so no host time lies between launches."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def check_kernels(sizes, buckets):
    """Bitwise checks of every kernel against its plain version; returns
    ``{kernel: max_abs_err}`` (0.0 when every check is bitwise).
    ``buckets``: the leaf sizes of each bucket of the overlap plan."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.ops.codecs import BlockQuantizeCodec

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_for = BlockQuantizeCodec()._rows_for
    errs = {k: 0.0 for k in REPLACES}
    n_checks = {k: 0 for k in REPLACES}

    def record(name, ours, ref, what):
        n_checks[name] += 1
        errs[name] = max(errs[name], abs_err(ours, ref))
        if not same_bits(ours, ref):
            fail(f"{name} differs from its plain version ({what}): "
                 f"max abs err {abs_err(ours, ref)}")

    def grad(n, scale):
        return torch.randn(n, device="cuda", generator=gen) * scale

    # (what, flat gradient, rows per tile, None or (kind, tile, element):
    # a tile whose scale must be 1.0 and whose code at `element` (a NaN)
    # or everywhere (a zero tile) must be 0).  The main path's sizes and
    # tiles; three 8-row tiles holding a zero tile and a NaN tile; a ragged
    # tail and a start only 4-byte aligned (the scalar loads).  Then
    # block_quantize's clusters (ck.cluster_ctas CTAs per tile, each CTA a
    # contiguous share): a tile for each cluster size, among them shares
    # that leave some threads short (72 and 264 rows); at 512 rows (8 CTAs
    # of 8,192 elements) a tile whose max is its last element (rank 7's
    # share), a NaN in rank 5's share, a zero tile, and an unaligned start
    # with a ragged tail over three tiles.
    cases = [(f"resnet18 #{i} n={n}", grad(n, 10.0 ** (i % 5 - 3)),
              rows_for(n), None) for i, n in enumerate(sizes)]
    zero = grad(3 * 1024, 1.0)
    zero[:1024] = 0.0
    cases.append(("zero tile", zero, 8, ("zero", 0, 0)))
    nan = grad(3 * 1024, 1.0)
    nan[1024 + 5] = float("nan")
    cases.append(("nan tile", nan, 8, ("nan", 1, 1024 + 5)))
    cases.append(("ragged tail", grad(512 * 128 + 77, 1.0), 512, None))
    cases.append(("unaligned start", grad(70001, 1.0)[1:], 512, None))
    cluster_rows = (8, 72, 128, 136, 256, 264, 512)
    sizes_seen = {ck.cluster_ctas(r * ck.LANE) for r in cluster_rows}
    if sizes_seen != {1, 2, 4, 8}:
        fail(f"the cluster cases cover cluster sizes {sizes_seen}")
    for r in cluster_rows:
        c = ck.cluster_ctas(r * ck.LANE)
        cases.append((f"{c}-CTA cluster, {r} rows", grad(
            2 * r * ck.LANE - 3, 1.0), r, None))
    tile = 512 * ck.LANE
    last = grad(2 * tile, 1.0)
    last[tile - 1] = 1e3
    cases.append(("max in the last CTA", last, 512, None))
    nan = grad(2 * tile, 1.0)
    nan[tile + 5 * tile // 8 + 17] = float("nan")
    cases.append(("NaN in CTA rank 5", nan, 512,
                  ("nan", 1, tile + 5 * tile // 8 + 17)))
    zero = grad(2 * tile, 1.0)
    zero[:tile] = 0.0
    cases.append(("zero tile, 8-CTA cluster", zero, 512, ("zero", 0, 0)))
    cases.append(("unaligned ragged, 3 tiles",
                  grad(3 * tile + 78, 1.0)[1:], 512, None))
    # Past the registers: 1,024-row tiles, 8 CTAs of 16,384 elements, of
    # which each thread reads what it does not hold a second time.
    cases.append(("1024-row tiles", grad(2 * 1024 * ck.LANE - 3, 1.0), 1024,
                  None))

    for bits in (8, 16):
        stacks = []
        for what, x, rows, special in cases:
            q, s = ck.block_quantize(x, bits=bits, block_rows=rows)
            rq, rs = ck.block_quantize_ref(ck.pad_to_blocks(x, rows)[0],
                                           bits=bits, block_rows=rows)
            record("block_quantize", q, rq, f"{what} bits={bits}")
            record("block_quantize", s, rs, f"{what} bits={bits} scales")
            if special is not None:
                kind, t, e = special
                codes = q.view(-1)[t * rows * ck.LANE:(t + 1) * rows * ck.LANE]
                bad = (bool(codes.any()) if kind == "zero"
                       else int(q.view(-1)[e]) != 0)
                if float(s[t, 0]) != 1.0 or bad:
                    fail(f"{what}: tile {t}'s scale must be 1.0 and its "
                         f"{'codes' if kind == 'zero' else 'NaN code'} 0")
            stacks.append((what, rows, q, s))
        for world in (1, 4):
            for what, rows, q, s in stacks:
                qs = torch.stack([q] * world)
                ss = torch.stack([s * (1 + r) for r in range(world)])
                record("block_dequant_sum",
                       ck.block_dequant_sum(qs, ss, block_rows=rows),
                       ck.block_dequant_sum_ref(qs, ss, block_rows=rows),
                       f"{what} bits={bits} world={world}")
        # Codes as a strided view of a gathered bucket: ranks a bucket
        # apart, each rank's codes starting mid-bucket, 16-byte aligned
        # (2,048) or not (2,049: the element-wise path, and ranks an odd
        # number of codes apart).
        _, rows, q, s = stacks[1]
        world = 4
        for start in (2048, 2049):
            bucket = torch.zeros((world, start + q.numel()), dtype=q.dtype,
                                 device="cuda")
            bucket[:, start:] = q.view(-1)
            scales = torch.zeros((world, 3 + s.numel()), device="cuda")
            scales[:, 3:] = s.view(-1)
            qv = bucket[:, start:].view(world, *q.shape)
            sv = scales[:, 3:].view(world, *s.shape)
            record("block_dequant_sum",
                   ck.block_dequant_sum(qv, sv, block_rows=rows),
                   ck.block_dequant_sum_ref(qv, sv, block_rows=rows),
                   f"strided bucket view at {start} bits={bits}")

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for world in (1, 4):
            for what, x, *_ in cases:
                wire = torch.stack([x * (r + 1) for r in range(world)]).to(
                    dtype)
                record("cast_sum", ck.cast_sum(wire), ck.cast_sum_ref(wire),
                       f"{what} {dtype} world={world}")
            # A leaf at an odd offset of a gathered bucket: the scalar path.
            bucket = torch.stack([grad(4099, 1.0) for _ in range(world)]).to(
                dtype)
            view = bucket[:, 3:]
            record("cast_sum", ck.cast_sum(view), ck.cast_sum_ref(view),
                   f"odd bucket offset {dtype} world={world}")
    check_groups(record, sizes)
    check_fused_buckets(record, buckets)
    torch.cuda.synchronize()
    for k in REPLACES:
        print(f"[kernels] {k}: {n_checks[k]} checks bitwise equal to the "
              f"plain version (max abs err {errs[k]})")
    return errs


# A group laid out as the step gathers it (`allgather_tree_bucketed`,
# default buckets): shared buckets holding leaves at odd element offsets
# (1, 77, 10, 3 and 5 elements among them), solo leaves (the ones of 256
# KiB or more: 147,456 elements but for int8 codes, 600,000, 2,359,299),
# and blockq tiles of 8 to 512 rows.
MIXED_SIZES = (1, 77, 10, 1728, 4099, 64, 36864, 147456, 3, 600000, 5, 513,
               70001, 2359299)


def _gathered(tree, world):
    """``tree`` as `allgather_tree_bucketed` hands it to the decode on
    ``world`` ranks, gathered in this process: the same buckets, each a
    ``(world, length)`` tensor, shared leaves as strided views of it.  The
    ranks' copies differ: codes negated on odd ranks, floats scaled by the
    rank + 1."""
    import torch

    from pytorch_ps_mpi_tpu_torch.parallel import collectives as C

    def gather(flat):
        if flat.dtype.is_floating_point:
            ranks = [(flat.float() * (r + 1)).to(flat.dtype)
                     for r in range(world)]
        else:
            ranks = [flat if r % 2 == 0 else -flat for r in range(world)]
        return torch.stack(ranks)

    bucket = C.DEFAULT_BUCKET_BYTES
    return C._bucketed_leafwise(tree, gather, bucket,
                                C._solo_default(bucket, None))


def _group_case(record, kind, leaves, what):
    """One group call held bitwise against the per-leaf plain versions,
    with its launch count and its layout (one f32 buffer, each leaf's view
    at an offset padded to 4 elements).  Returns the launches."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    before = ck.LAUNCHES[kind]
    if kind == "block_dequant_sum":
        flat, views = ck.block_dequant_sum_group(leaves)
        refs = [ck.block_dequant_sum_ref(q, s, block_rows=r).view(-1)[:n]
                for q, s, n, r in leaves]
    else:
        flat, views = ck.cast_sum_group(leaves)
        refs = [ck.cast_sum_ref(x) for x in leaves]
    launches = ck.LAUNCHES[kind] - before
    want = ck.group_launches(kind, len(leaves))
    if launches != want:
        fail(f"{kind} {what}: {launches} launches for {len(leaves)} leaves, "
             f"expected {want}")
    base = flat.data_ptr()
    for v, ref in zip(views, refs):
        if (v.shape != ref.shape or (v.data_ptr() - base) % 16
                or not base <= v.data_ptr() < base + 4 * flat.numel()):
            fail(f"{kind} {what}: a view of shape {tuple(v.shape)} at byte "
                 f"{v.data_ptr() - base} of the group's buffer")
    record(kind, torch.cat(views), torch.cat(refs),
           f"group of {len(leaves)}: {what}")
    return launches


def check_groups(record, sizes):
    """The grouped decode sums bitwise against the per-leaf plain versions:
    the 62 ResNet-18 leaves, the 150 LM leaves and `MIXED_SIZES`, each as
    one group laid out as the step gathers it, at worlds 1 and 4 (and 9,
    past the kernels' 8 unrolled ranks, for the mixed group), bits 8 and
    16, bf16, f16 and f32 wires; then a group long enough to be split
    across launches."""
    import torch

    from pytorch_ps_mpi_tpu_torch.models import TransformerLM
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    with torch.device("meta"):
        lm = TransformerLM(**LM)
    groups = {"ResNet-18": list(sizes),
              "LM": [p.numel() for p in lm.parameters()],
              "mixed": list(MIXED_SIZES)}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, ns in groups.items():
        worlds = (1, 4, 9) if name == "mixed" else (1, 4)
        flat = torch.randn(sum(ns), device="cuda", generator=gen) * 1e-2
        offs = [sum(ns[:i]) for i in range(len(ns))]
        grads = {f"p{i:03d}": flat[o:o + n]
                 for i, (o, n) in enumerate(zip(offs, ns))}
        for bits in (8, 16):
            codes = {k: dict(zip(("q", "scales"), ck.block_quantize(
                g, bits=bits, block_rows=ck.rows_for_flat(g.numel()))))
                for k, g in grads.items()}
            for world in worlds:
                got = _gathered(codes, world)
                leaves = [(got[k]["q"], got[k]["scales"], g.numel(),
                           ck.rows_for_flat(g.numel()))
                          for k, g in grads.items()]
                n = _group_case(record, "block_dequant_sum", leaves,
                                f"{name} bits={bits} world={world}")
            del codes, got, leaves
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            wires = {k: g.to(dtype) for k, g in grads.items()}
            for world in worlds:
                got = _gathered(wires, world)
                m = _group_case(record, "cast_sum",
                                [got[k] for k in grads],
                                f"{name} {dtype} world={world}")
            del wires, got
        print(f"[kernels] {name}: {len(ns)} leaves as one group, "
              f"{n} block_dequant_sum and {m} cast_sum launch(es)")
        del flat, grads
        torch.cuda.empty_cache()
    # Split across launches: more leaves than the large table holds.
    for kind in ("block_dequant_sum", "cast_sum"):
        cap = ck.group_capacity(kind)
        count = cap["large"] + 37
        ns = torch.randint(1, 3000, (count,), generator=gen,
                           device="cuda").tolist()
        grads = {f"p{i:04d}": torch.randn(n, device="cuda", generator=gen)
                 for i, n in enumerate(ns)}
        if kind == "block_dequant_sum":
            codes = {k: dict(zip(("q", "scales"), ck.block_quantize(
                g, block_rows=ck.rows_for_flat(g.numel()))))
                for k, g in grads.items()}
            got = _gathered(codes, 2)
            leaves = [(got[k]["q"], got[k]["scales"], g.numel(),
                       ck.rows_for_flat(g.numel())) for k, g in grads.items()]
        else:
            got = _gathered({k: g.to(torch.bfloat16)
                             for k, g in grads.items()}, 2)
            leaves = [got[k] for k in grads]
        n = _group_case(record, kind, leaves, "split, world=2")
        print(f"[kernels] {kind}: {count} leaves in {n} launches of at "
              f"most {cap['large']} leaves (a {cap['param_bytes']}-byte "
              f"parameter table; 4,096 bytes would hold {cap['small']}; "
              f"CUDA runtime {cap['runtime']}, CUDA driver "
              f"{cap['cuda_driver']})")


def check_fused_buckets(record, buckets):
    """The fused overlap path's kernels at its shapes: each bucket of the
    ResNet-18 overlap plan (``buckets``: leaf sizes) concatenated from a
    seeded gradient and quantized as one tensor, tiles of
    ``rows_for_flat(bucket size)`` rows straddling its leaves, against
    `block_quantize_ref`; then one grouped `block_dequant_sum` with a leaf
    per bucket, at worlds 1 and 4, against `block_dequant_sum_ref`.  All
    bitwise."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(6)
    codes = []
    for i, ns in enumerate(buckets):
        flat = torch.cat([torch.randn(n, device="cuda", generator=gen)
                          * 10.0 ** (j % 5 - 3) for j, n in enumerate(ns)])
        n, rows = flat.numel(), ck.rows_for_flat(flat.numel())
        q, s = ck.block_quantize(flat, block_rows=rows)
        rq, rs = ck.block_quantize_ref(ck.pad_to_blocks(flat, rows)[0],
                                       block_rows=rows)
        what = f"fused bucket {i}: {len(ns)} leaves, n={n}, {rows} rows"
        record("block_quantize", q, rq, what)
        record("block_quantize", s, rs, f"{what}, scales")
        codes.append((q, s, n, rows))
    for world in (1, 4):
        leaves = [(torch.stack([q if r % 2 == 0 else -q
                                for r in range(world)]),
                   torch.stack([s * (1 + r) for r in range(world)]), n, rows)
                  for q, s, n, rows in codes]
        launches = _group_case(record, "block_dequant_sum", leaves,
                               f"{len(codes)} fused buckets world={world}")
    print(f"[kernels] the {len(buckets)} fused buckets of the ResNet-18 "
          f"overlap plan ({sum(c[2] for c in codes)} elements): "
          f"block_quantize bitwise per bucket; block_dequant_sum bitwise in "
          f"{launches} grouped launch(es) at worlds 1 and 4")


def host_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean host-clock time of ``fn()`` from its call to the device's end
    of its work (synchronised after the last of ``reps`` calls)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def time_kernels(sizes):
    """Time each codec kernel over one step's worth of work at the main
    path's shapes (the 62 ResNet-18 tensors, world 1) against its plain
    version, a library call where one computes the same function, and its
    bound.  ``block_quantize``: CUDA events around the 62 calls of the
    host loop.  The grouped decode sums: device time of one launch over
    the 62 leaves as the step gathers them (CUDA graph; four copies of the
    codes in turn, so L2 does not hold the input), beside the host-clock
    time of the call; the per-leaf plain versions and the library call
    timed the same two ways."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.ops.codecs import BlockQuantizeCodec

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_for = BlockQuantizeCodec()._rows_for
    grads = [torch.randn(n, device="cuda", generator=gen) * 1e-2
             for n in sizes]
    rows = [rows_for(n) for n in sizes]
    q_bytes = sum(g.numel() * 4 + -(-g.numel() // (r * ck.LANE)) * (
        r * ck.LANE + 4) for g, r in zip(grads, rows))
    out = {"block_quantize": dict(
        ms=time_ms(lambda: [ck.block_quantize(g, block_rows=r)
                            for g, r in zip(grads, rows)]),
        plain_ms=time_ms(lambda: [
            ck.block_quantize_ref(ck.pad_to_blocks(g, r)[0], block_rows=r)
            for g, r in zip(grads, rows)]),
        bytes=q_bytes, library_ms=None)}
    tree = {f"p{i:02d}": g for i, g in enumerate(grads)}
    copies = 4
    dq = []
    for _ in range(copies):
        codes = _gathered({k: dict(zip(("q", "scales"), ck.block_quantize(
            g, block_rows=rows_for(g.numel())))) for k, g in tree.items()}, 1)
        dq.append([(codes[k]["q"], codes[k]["scales"], g.numel(),
                    rows_for(g.numel())) for k, g in tree.items()])
    casts = [[w.view(1, -1) for w in _gathered(
        {k: g.to(torch.bfloat16) for k, g in tree.items()}, 1).values()]
        for _ in range(copies)]
    wires = [torch.cat([w.view(-1) for w in c]).view(1, -1) for c in casts]
    d_bytes = sum(q.numel() * q.element_size() + s.numel() * 4 + n * 4
                  for q, s, n, _ in dq[0])
    c_bytes = sum(w.numel() * w.element_size() + w.shape[1] * 4
                  for w in casts[0])

    def each(fn, args):
        return lambda: [fn(a) for a in args]

    def plain_dq(leaves):
        return [ck.block_dequant_sum_ref(q, s, block_rows=r)
                for q, s, _, r in leaves]

    def plain_cast(leaves):
        return [ck.cast_sum_ref(x) for x in leaves]

    def library(w):
        return torch.sum(w, 0, dtype=torch.float32)

    for k, group, plain, args, nbytes, lib in (
            ("block_dequant_sum", ck.block_dequant_sum_group, plain_dq, dq,
             d_bytes, None),
            ("cast_sum", ck.cast_sum_group, plain_cast, casts, c_bytes,
             library)):
        ck.reset_launch_counts()
        group(args[0])
        launches = ck.LAUNCHES[k]
        rec = dict(
            ms=time_graph_ms(each(group, args), copies),
            host_ms=host_ms(lambda: group(args[0])),
            plain_ms=time_graph_ms(each(plain, args), copies),
            plain_host_ms=host_ms(lambda: plain(args[0])),
            bytes=nbytes, library_ms=None, launches=launches)
        if lib is not None:
            rec["library_ms"] = time_graph_ms(each(lib, wires), copies)
            rec["library_host_ms"] = host_ms(lambda: lib(wires[0]))
        out[k] = rec
    for k, v in out.items():
        v["bound_ms"] = v["bytes"] / H100_BYTES_PER_S * 1e3
        lib = ("null" if v["library_ms"] is None
               else f"{v['library_ms']:.4f} ms")
        if k == "block_quantize":
            print(f"[kernels] {k}: {len(sizes)} calls (one step, world 1): "
                  f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {v['bound_ms']:.4f} ms "
                  f"({v['bytes']} bytes at 3.35 TB/s)")
            continue
        lib_host = ("" if v["library_ms"] is None else
                    f" (host {v['library_host_ms']:.4f} ms)")
        print(f"[kernels] {k}: one group of {len(sizes)} leaves (one step, "
              f"world 1), {v['launches']} launch(es): device {v['ms']:.4f} "
              f"ms (CUDA graph), {v['bound_ms'] / v['ms']:.3f} of the bound; "
              f"host {v['host_ms']:.4f} ms per call; plain versions, "
              f"{len(sizes)} calls: device {v['plain_ms']:.4f} ms, host "
              f"{v['plain_host_ms']:.4f} ms; library {lib}{lib_host}; bound "
              f"{v['bound_ms']:.4f} ms ({v['bytes']} bytes at 3.35 TB/s)")
    del dq, casts, wires
    time_block_quantize_alone(max(sizes))
    time_decode_alone()
    return out


def time_decode_alone():
    """The two grouped decode sums alone on the LM's token embedding
    (33,554,432 elements, one leaf, world 1; blockq codes in 512-row
    tiles, a bf16 wire): device time per launch from a CUDA graph, against
    the bytes bound."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(5)
    n = LM["vocab_size"] * LM["d_model"]
    g = torch.randn(n, device="cuda", generator=gen) * 1e-2
    q, s = ck.block_quantize(g)
    leaf = [(q[None], s[None], n, ck.BLOCK_ROWS)]
    wire = [g.to(torch.bfloat16)[None]]
    for k, fn, args, nbytes in (
            ("block_dequant_sum", ck.block_dequant_sum_group, leaf,
             q.numel() + s.numel() * 4 + n * 4),
            ("cast_sum", ck.cast_sum_group, wire, n * 2 + n * 4)):
        ms = time_graph_ms(lambda: fn(args), 1)
        bound = nbytes / H100_BYTES_PER_S * 1e3
        print(f"[kernels] {k} alone, LM embedding (n={n}): device "
              f"{ms * 1e3:.2f} us per launch (CUDA graph), bound "
              f"{bound * 1e3:.2f} us ({nbytes} bytes at 3.35 TB/s), "
              f"{bound / ms:.3f} of the bound")


def time_block_quantize_alone(resnet_max):
    """block_quantize alone at two main-path sizes, the largest ResNet-18
    gradient and the LM's token embedding (33,554,432 elements), 512-row
    tiles: device time per launch from a CUDA graph (eight gradients in
    turn for the ResNet one, 75 MB, so the 50 MB L2 does not hold the
    input), and the host-loop time, against the bytes bound."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(3)
    for what, n, copies in (("ResNet-18 largest", resnet_max, 8),
                            ("LM embedding", LM["vocab_size"] * LM["d_model"],
                             1)):
        grads = [torch.randn(n, device="cuda", generator=gen) * 1e-2
                 for _ in range(copies)]
        n_blocks = -(-n // (ck.BLOCK_ROWS * ck.LANE))
        nbytes = n * 4 + n_blocks * ck.BLOCK_ROWS * ck.LANE + n_blocks * 4

        def run():
            for g in grads:
                ck.block_quantize(g)

        graph_ms = time_graph_ms(run, copies)
        loop_ms = time_ms(run) / copies
        bound = nbytes / H100_BYTES_PER_S * 1e3
        print(f"[kernels] block_quantize alone, {what} (n={n}, {n_blocks} "
              f"tiles x {ck.cluster_ctas(ck.BLOCK_ROWS * ck.LANE)} CTAs): "
              f"device {graph_ms * 1e3:.2f} us per launch (CUDA graph), "
              f"host loop {loop_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
              f"({nbytes} bytes at 3.35 TB/s), {bound / graph_ms:.3f} of "
              f"the bound")
        del grads


# ---------------------------------------------------------------------------
# Phase 2b: the flash attention kernels against their plain versions
# ---------------------------------------------------------------------------

# (name, B, S, H, D, causal, dtype, scale, views): the LM's main-path shape
# first, its q/k/v strided views of one [B, S, H, 3, D] projection as the
# model passes them; then D = 128, a ragged S, non-causal, a scale
# override, f32 (at D = 128 the dK/dV kernel's 32-row q tiles), odd head
# dims that go through the zero padding, and the edges of the bf16
# kernels' 128-row blocks: one real row in the last block (S = 129), a
# block whose second warpgroup holds one real row (S = 65), the longest
# causal sweep (S = 2048), and D = 128 at a ragged S as strided views.
FLASH_CASES = (
    ("main", 16, 1024, 16, 64, True, "bfloat16", None, True),
    ("d128", 4, 512, 8, 128, True, "bfloat16", None, False),
    ("ragged S=1000", 2, 1000, 4, 64, True, "bfloat16", None, False),
    ("non-causal", 2, 512, 4, 64, False, "bfloat16", None, False),
    ("scale=0.2", 2, 256, 4, 64, True, "bfloat16", 0.2, False),
    ("f32", 2, 333, 4, 64, True, "float32", None, False),
    ("f32 d128 non-causal", 2, 200, 2, 128, False, "float32", None, False),
    ("odd D=20", 2, 300, 4, 20, True, "bfloat16", None, False),
    ("odd D=96 f32", 1, 130, 2, 96, True, "float32", None, False),
    ("S=129", 2, 129, 4, 64, True, "bfloat16", None, False),
    ("S=65", 2, 65, 4, 64, True, "bfloat16", None, False),
    ("B=H=1 S=2048", 1, 2048, 1, 64, True, "bfloat16", None, False),
    ("d128 S=1000 views", 2, 1000, 4, 128, True, "bfloat16", None, True),
    ("serve", 4, 1024, 16, 64, True, "bfloat16", None, True),
)
# The serve tier's decode step (phase 10a): the bench LM's heads over the
# front-end's [max_batch, buf_len] buffer, causal, bf16.
FLASH_SERVE = FLASH_CASES[-1]
# Kernel against plain version, elementwise |a - b| <= atol + rtol * |b|.
# Both compute the same tile math, but the products sum in other orders
# (wgmma or FMA chains against cuBLAS) and exp differs in the last bit, so:
# f32 agrees to f32 rounding of sums of up to S terms; in bf16, p and ds
# are rounded to bf16 in both, and a last-bit difference in a score can
# move that rounding by one bf16 step (2^-8 relative), and every output is
# rounded to bf16 at the end.  lse is f32 in both cases.
FLASH_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, NVIDIA data sheet
H100_F32_FLOPS = 67e12    # f32 off the tensor cores, NVIDIA data sheet


def _flash_inputs(b, s, h, d, dtype, seed, as_views):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dt)

    if as_views:
        q, k, v = rnd(b, s, h, 3, d).unbind(3)
    else:
        q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    return q, k, v, rnd(b, s, h, d)


def _dense_f32(q, k, v, do, causal, scale):
    """An f32 dense reference from the same inputs: ``(o, dq, dk, dv)``."""
    import torch

    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        s = sc.shape[-1]
        keep = torch.ones((s, s), dtype=torch.bool, device=sc.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), vf)
    grads = torch.autograd.grad(o, (qf, kf, vf), do.float())
    return (o.detach(), *grads)


def check_flash_kernels():
    """Each flash kernel against its plain version on every case of
    FLASH_CASES; prints each output's max abs error, and both kernel and
    plain version against an f32 dense reference.  Returns ``{kernel: max
    abs err}`` over all cases."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa

    errs = {k: 0.0 for k in FLASH_REPLACES}
    for i, (what, b, s, h, d, causal, dtype, scale, views) in enumerate(
            FLASH_CASES):
        q, k, v, do = _flash_inputs(b, s, h, d, dtype, 10 + i, views)
        sc = d ** -0.5 if scale is None else scale
        kw = dict(causal=causal, scale=sc)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_fwd_ref(q, k, v, **kw)
        delta = torch.sum(do.float() * o.float(), -1).transpose(1, 2)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        rdq, rdk, rdv = fa.flash_bwd_ref(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        dense = _dense_f32(q, k, v, do, causal, sc)
        pairs = (("flash_fwd", "o", o, ro, dense[0]),
                 ("flash_fwd", "lse", lse, rlse, None),
                 ("flash_bwd_dq", "dq", dq, rdq, dense[1]),
                 ("flash_bwd_dkdv", "dk", dk, rdk, dense[2]),
                 ("flash_bwd_dkdv", "dv", dv, rdv, dense[3]))
        line = []
        for kernel, out, ours, ref, want in pairs:
            tol = LSE_TOL if out == "lse" else FLASH_TOL[dtype]
            if ours.shape != ref.shape or ours.dtype != ref.dtype:
                fail(f"{kernel} {what}: {out} is {tuple(ours.shape)} "
                     f"{ours.dtype}, its plain version {tuple(ref.shape)} "
                     f"{ref.dtype}")
            err = abs_err(ours, ref)
            errs[kernel] = max(errs[kernel], err)
            if not torch.allclose(ours.float(), ref.float(), **tol):
                fail(f"{kernel} {what}: {out} differs from its plain "
                     f"version beyond rtol={tol['rtol']}, "
                     f"atol={tol['atol']}: max abs err {err}")
            vs = ("" if want is None else
                  f" (vs f32 dense: kernel {abs_err(ours, want):.3g}, "
                  f"plain {abs_err(ref, want):.3g})")
            line.append(f"{out} {err:.3g}{vs}")
        print(f"[flash] {what} [{b},{s},{h},{d}] {dtype} causal={causal} "
              f"scale={sc:.4g}: max abs err kernel vs plain: "
              + "; ".join(line))
        del dense
    torch.cuda.synchronize()
    return errs


def print_flash_occupancy():
    """How the three bf16 flash kernels occupy the card, at both head dims,
    from cudaFuncGetAttributes and the occupancy calculator; a spill
    fails."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa

    for kernel in FLASH_REPLACES:
        for d in fa.HEAD_DIMS:
            info = fa.kernel_info(kernel, torch.bfloat16, d)
            print(f"[flash] {kernel} bf16 D={d}: {info['threads']} threads "
                  f"and {info['rows']} rows per block, {info['registers']} "
                  f"registers per thread ({info['local_bytes']} local "
                  f"bytes), {info['smem_bytes']} bytes of shared memory "
                  f"per block, {info['blocks_per_sm']} resident blocks per "
                  f"SM")
            if info["local_bytes"]:
                fail(f"{kernel} bf16 D={d} spills {info['local_bytes']} "
                     "bytes per thread to local memory")


def _flash_bound(kernel, b, s, h, d, causal, elt):
    """``(bound ms, "bytes" or "operations", flops, bytes)`` at bf16's
    tensor-core peak: operations over 989 TFLOP/s against bytes (each input
    read once, each output written once) over 3.35 TB/s, counting only
    the unmasked (q, k) pairs when causal."""
    pairs = s * (s + 1) // 2 if causal else s * s
    n, rows = b * s * h * d, b * h * s
    flops, nbytes = {
        "flash_fwd": (4 * d * pairs * b * h, 4 * n * elt + 4 * rows),
        "flash_bwd_dkdv": (8 * d * pairs * b * h, 6 * n * elt + 8 * rows),
        "flash_bwd_dq": (6 * d * pairs * b * h, 5 * n * elt + 8 * rows),
    }[kernel]
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def time_flash_kernels():
    """Each flash kernel at the main-path shape (CUDA events) beside its
    plain version, its bound and, as a yardstick the port never calls,
    F.scaled_dot_product_attention: forward alone against the forward
    kernel, its whole backward (dq, dk and dv in one call) against each
    backward kernel."""
    import torch
    import torch.nn.functional as F

    from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa

    what, b, s, h, d, causal, dtype, _, _ = FLASH_CASES[0]
    q, k, v, do = _flash_inputs(b, s, h, d, dtype, 1, as_views=True)
    kw = dict(causal=causal, scale=d ** -0.5)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = torch.sum(do.float() * o.float(), -1).transpose(1, 2)
    bwd = (q, k, v, do, lse, delta)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    sdpa = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qh.detach(), kh.detach(), vh.detach(), is_causal=causal))
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa, (qh, kh, vh), doh, retain_graph=True))
    lib_step = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal),
        (qh, kh, vh), doh))
    out = {
        "flash_fwd": dict(
            ms=time_ms(lambda: fa.flash_fwd(q, k, v, **kw)),
            plain_ms=time_ms(lambda: fa.flash_fwd_ref(q, k, v, **kw),
                             reps=5),
            library_ms=lib_fwd),
        "flash_bwd_dkdv": dict(
            ms=time_ms(lambda: fa.flash_bwd_dkdv(*bwd, **kw)),
            plain_ms=time_ms(lambda: fa.flash_bwd_dkdv_ref(*bwd, **kw),
                             reps=5),
            library_ms=lib_bwd),
        "flash_bwd_dq": dict(
            ms=time_ms(lambda: fa.flash_bwd_dq(*bwd, **kw)),
            plain_ms=time_ms(lambda: fa.flash_bwd_dq_ref(*bwd, **kw),
                             reps=5),
            library_ms=lib_bwd),
    }
    for kernel, rec in out.items():
        bound, by, flops, nbytes = _flash_bound(kernel, b, s, h, d, causal,
                                                q.element_size())
        rec.update(bound_ms=bound, bound_by=by)
        print(f"[flash] {kernel} [{b},{s},{h},{d}] {dtype} causal: kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
              f"{rec['library_ms']:.4f} ms, bound {bound:.4f} ms ({by}: "
              f"{flops} operations at 989 TFLOP/s, {nbytes} bytes at "
              f"3.35 TB/s; {flops / rec['ms'] / 1e9:.1f} TFLOP/s achieved)")
    print(f"[flash] library F.scaled_dot_product_attention: forward "
          f"{lib_fwd:.4f} ms, backward (dq, dk, dv) {lib_bwd:.4f} ms, "
          f"forward + backward {lib_step:.4f} ms; the kernels' forward + "
          f"backward {sum(r['ms'] for r in out.values()):.4f} ms")
    return out


def time_flash_serve_shape():
    """``flash_fwd`` at the serve tier's decode shape (CUDA events) beside
    its bound and, as a yardstick the port never calls,
    F.scaled_dot_product_attention's forward at that shape."""
    import torch.nn.functional as F

    from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa

    _, b, s, h, d, causal, dtype, _, _ = FLASH_SERVE
    q, k, v, _ = _flash_inputs(b, s, h, d, dtype, 3, as_views=True)
    kw = dict(causal=causal, scale=d ** -0.5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, **kw))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal))
    bound, by, flops, nbytes = _flash_bound("flash_fwd", b, s, h, d, causal,
                                            q.element_size())
    print(f"[flash] flash_fwd at the serve shape [{b},{s},{h},{d}] {dtype} "
          f"causal: kernel {ms:.4f} ms, library (scaled_dot_product_"
          f"attention, forward) {lib:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{flops} operations at 989 TFLOP/s, {nbytes} bytes at 3.35 TB/s;"
          f" {flops / ms / 1e9:.1f} TFLOP/s achieved)")


# ---------------------------------------------------------------------------
# Phase 3: the slice
# ---------------------------------------------------------------------------


def reset_launch_counts() -> None:
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa

    ck.reset_launch_counts()
    fa.reset_launch_counts()


def launch_counts() -> "dict[str, int]":
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa

    return {**ck.LAUNCHES, **fa.LAUNCHES}


def expect_counts(what, counts, **want) -> None:
    """Fail unless every kernel launched exactly ``want`` times (0 for a
    kernel not named)."""
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        fail(f"{what}: launch counts {counts}, expected {full}")


def drive(code, named, loss_fn, batch, group, warm, timed, *, lr,
          has_aux=False, aux=None, compile_kw=None, **options):
    """Run ``warm`` blocking steps and ``timed`` queued steps of
    ``SGD(lr, momentum=0.9)`` with ``code`` and the step ``options``
    (``sync_mode``, ``fused_encode``, ``profile``, ``zero``, ...) and
    ``compile_step``'s ``compile_kw`` (``accum_steps``, ``remat``); the
    launch counts are zeroed just before and read just after.  Returns
    (optimizer, losses, counts, seconds of the timed steps, last
    metrics)."""
    import torch

    from pytorch_ps_mpi_tpu_torch import SGD

    opt = SGD(list(named.items()), lr=lr, momentum=0.9, code=code,
              device="cuda", group=group, **options)
    opt.compile_step(loss_fn, has_aux=has_aux, aux=aux, **(compile_kw or {}))
    reset_launch_counts()
    losses = []
    for _ in range(warm):
        loss, metrics = opt.step(batch)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        loss, metrics = opt.step(batch, block=False)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in losses]
    return opt, losses, counts, seconds, metrics


_CATEGORIES = (
    ("block_quantize", ("block_quantize_kernel",)),
    ("block_dequant_sum", ("dequant_sum_group_kernel",)),
    ("cast_sum", ("cast_sum_group_kernel",)),
    ("flash_fwd", ("flash_fwd_",)),
    ("flash_bwd_dkdv", ("flash_bwd_dkdv_",)),
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("nccl", ("nccl",)),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("softmax/cross-entropy", ("softmax", "nll_loss")),
    # The models' only f32 matmuls are their heads' (the LM's lm_head:
    # forward, dgrad, wgrad); cuBLAS names its f32 kernels sgemm, f32f32
    # or nvjet_sss.
    ("f32 GEMM (heads)", ("sgemm", "f32f32", "nvjet_sss", "simt")),
    ("conv/matmul", ("conv", "xmma", "gemm", "cudnn", "implicit", "wgrad",
                     "dgrad", "fprop", "sm90", "nvjet", "cutlass")),
)


def profile_steps(opt, batch, what, steps: int = 2):
    """Device time of ``steps`` queued steps by kernel category, from
    torch.profiler's CUDA events, and the device's busy share of the wall
    time under the profiler (kernel time over host-clock time to
    synchronize).  Returns the device kernel ms per step and the kernels
    a step, or (None, None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            opt.step(batch, block=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("[profile] the profiler saw no CUDA kernels: device time "
              "not measured")
        return None, None
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "elementwise/other")
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = sum(by_cat.values())
    print(f"[profile] {steps} {what} steps: wall "
          f"{wall_us / steps / 1e3:.3f} "
          f"ms/step, device kernel time {busy / steps / 1e3:.3f} ms/step, "
          f"busy share under the profiler {busy / wall_us:.3f}, "
          f"{len(kernels) // steps} kernels/step")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cat}: {us / steps / 1e3:.3f} ms/step "
              f"({us / busy:.3f} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   top: {us / steps / 1e3:.3f} ms/step  {name[:110]}")
    return busy / steps / 1e3, len(kernels) // steps


def check_params_finite(opt, what):
    import torch

    for n, p in opt.params.items():
        if not bool(torch.isfinite(p).all()):
            fail(f"{what}: parameter {n} is not finite")


def _assert_close_runs(what, out, rtol, atol):
    """Card against CPU: losses and every parameter."""
    import numpy as np

    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=rtol)
    worst = 0.0
    for n, p in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][n], p, rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {n}")
        worst = max(worst, float(np.abs(out["cuda"][1][n] - p).max()))
    print(f"[slice] {what}, card vs CPU plain versions: losses "
          f"{out['cuda'][0]} vs {out['cpu'][0]}, max param diff {worst}")


def small_reference_check(group, cpu_group, code="blockq", **options):
    """A small MLP trained 3 steps with ``code`` and the step ``options``
    on the card (CUDA kernels) and on the CPU (plain versions), from the
    same numpy init and batches.  Tolerance rtol=1e-4, atol=1e-5: float32
    matmuls (TF32 off) sum in other orders on the two devices; the codes
    then agree, or differ by one quantum (lr * scale, ~1e-6 here; topk may
    swap two magnitudes within float32 noise of each other at the k-th,
    which moves a parameter by about lr * |g| of the two)."""
    import numpy as np

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_mnist
    from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn

    named = init_mlp(np.random.RandomState(0), (784, 64, 10))
    x, y = synthetic_mnist(256, seed=1)
    batch = {"x": x, "y": y}
    out = {}
    for device, grp in (("cuda", group), ("cpu", cpu_group)):
        opt = SGD(list(named.items()), lr=0.05, momentum=0.9, code=code,
                  device=device, group=grp, **options)
        opt.compile_step(mlp_loss_fn)
        losses = [opt.step(batch)[0] for _ in range(3)]
        out[device] = (losses, {n: p.cpu().numpy()
                                for n, p in opt.params.items()})
    _assert_close_runs(f"small MLP {code} {options or ''}".strip(), out,
                       1e-4, 1e-5)


def run_slice(group, cpu_group):
    import torch

    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_cifar10
    from pytorch_ps_mpi_tpu_torch.models import (build_model,
                                                 make_classifier_loss,
                                                 resnet18)
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    model = resnet18(num_classes=10, small_inputs=True, dtype=torch.bfloat16)
    named, aux = build_model(model, seed=0)
    loss_fn, has_aux = make_classifier_loss(model)
    if not has_aux or len(named) != 62 or len(aux) != 40:
        fail(f"ResNet-18 has {len(named)} tensors and {len(aux)} statistics")
    x, y = synthetic_cifar10(BATCH, seed=0)
    # Staged on the card once: the step is measured, not the input copy.
    batch = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}
    per_step = len(named)
    # The decode sums: one grouped launch for the step's 62 leaves (or the
    # split count, if the card's parameter space cannot hold them).
    dq_step = ck.group_launches("block_dequant_sum", per_step)
    cast_step = ck.group_launches("cast_sum", per_step)
    common = dict(lr=0.1, has_aux=True, aux=aux)

    torch.cuda.reset_peak_memory_stats()
    opt, losses, counts, seconds, metrics = drive(
        "blockq", named, loss_fn, batch, group, WARM, TIMED, **common)
    steps = WARM + TIMED
    print(f"[slice] blockq: {steps} steps, losses {losses}")
    print(f"[slice] blockq launches {counts} (expect {per_step}/step of "
          f"block_quantize, one per leaf, and {dq_step}/step of "
          f"block_dequant_sum: the {per_step} leaves in "
          f"{'one grouped launch' if dq_step == 1 else 'grouped launches'})")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"blockq losses must be finite and fall: {losses}")
    expect_counts("ResNet-18 blockq", counts,
                  block_quantize=per_step * steps,
                  block_dequant_sum=dq_step * steps)
    if (metrics["packaged_bytes"] != 11445104
            or metrics["msg_bytes"] != 44695848):
        fail(f"byte metrics {metrics}")
    check_params_finite(opt, "blockq")
    ms = seconds / TIMED * 1e3
    print(f"[slice] blockq ResNet-18 bf16 batch {BATCH}: {ms:.3f} ms/step, "
          f"{BATCH * TIMED / seconds:.1f} images/s per GPU "
          f"({TIMED} queued steps, host clock to synchronize); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    main_counts = counts
    images_per_s = BATCH * TIMED / seconds
    fused = run_overlap_fused(named, aux, loss_fn, batch, group, opt, ms)
    device_ms, kernels = profile_steps(opt, batch, "ResNet-18 blockq")
    if device_ms is not None:
        print(f"[slice] blockq device busy share without the profiler: "
              f"{device_ms / ms:.3f} (profiled device ms/step over the "
              f"timed ms/step)")
    del opt
    _, fused_kernels = profile_steps(fused, batch,
                                     "ResNet-18 overlap fused blockq")
    del fused
    run_overlap_unfused(named, aux, loss_fn, batch, group)

    opt, losses, counts, seconds, _ = drive(
        "bf16", named, loss_fn, batch, group, SIDE, 0, **common)
    print(f"[slice] bf16: losses {losses}, launches {counts} (expect "
          f"{cast_step}/step of cast_sum: the {per_step} leaves grouped)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"bf16 run: losses {losses}")
    expect_counts("ResNet-18 bf16", counts, cast_sum=cast_step * SIDE)
    check_params_finite(opt, "bf16")
    profile_steps(opt, batch, "ResNet-18 bf16")
    cast_counts = counts
    del opt

    opt, losses, counts, _, _ = drive(
        "identity", named, loss_fn, batch, group, SIDE, 0, **common)
    print(f"[slice] identity: losses {losses}, launches {counts}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"identity run: losses {losses}")
    expect_counts("ResNet-18 identity", counts)
    check_params_finite(opt, "identity")
    del opt
    compare_overlap_and_profile(named, aux, loss_fn, batch, group)
    print_kernels_a_step({"ResNet-18 blockq": kernels,
                          "ResNet-18 overlap fused blockq": fused_kernels})
    run_features(named, aux, loss_fn, batch, group, cpu_group)

    small_reference_check(group, cpu_group)
    small_reference_check(group, cpu_group, sync_mode="overlap",
                          fused_encode=True)
    return {"block_quantize": main_counts["block_quantize"],
            "block_dequant_sum": main_counts["block_dequant_sum"],
            "cast_sum": cast_counts["cast_sum"]}, images_per_s


def fused_wire_bytes(named, plan) -> int:
    """Bytes a fused blockq step gathers from each rank: per bucket, the
    int8 codes of its tiles and a float32 scale per tile, in one
    transfer."""
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    total = 0
    for names in plan.buckets:
        n = sum(named[x].numel() for x in names)
        tile = ck.rows_for_flat(n) * ck.LANE
        tiles = -(-n // tile)
        total += tiles * tile + tiles * 4
    return total


def queued_ms(opt, batch, steps: int) -> float:
    """ms/step of ``steps`` queued steps, host clock to synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.step(batch, block=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def run_overlap_fused(named, aux, loss_fn, batch, group, bucketed,
                      bucketed_ms):
    """ResNet-18 blockq through the overlap engine with the fused
    per-bucket encode (one block_quantize launch per bucket), warmed and
    timed like the bucketed run, then both timed again in turns (no
    profiler has run yet); launch counts, losses, byte metrics.  Returns
    the optimizer."""
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.parallel import overlap as OV

    plan = OV.plan_overlap(named, OVERLAP_BUCKET_BYTES, record=False)
    n_buckets = plan.n_buckets
    print(f"[overlap] ResNet-18 plan at {OVERLAP_BUCKET_BYTES} bytes: "
          f"{plan.describe()}; the fused step gathers "
          f"{fused_wire_bytes(named, plan)} bytes a step in {n_buckets} "
          f"transfers (packaged_bytes, the per-leaf wire: 11445104)")
    if n_buckets != 12:
        fail(f"the ResNet-18 overlap plan has {n_buckets} buckets, not 12")
    dq_step = ck.group_launches("block_dequant_sum", n_buckets)
    opt, losses, counts, seconds, metrics = drive(
        "blockq", named, loss_fn, batch, group, WARM, TIMED, lr=0.1,
        has_aux=True, aux=aux, sync_mode="overlap", fused_encode=True)
    steps = WARM + TIMED
    print(f"[overlap] fused blockq: {steps} steps, losses {losses}, "
          f"launches {counts} (expect {n_buckets}/step of block_quantize, "
          f"one per bucket, and {dq_step}/step of block_dequant_sum)")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"overlap fused blockq losses must be finite and fall: {losses}")
    expect_counts("ResNet-18 overlap fused blockq", counts,
                  block_quantize=n_buckets * steps,
                  block_dequant_sum=dq_step * steps)
    if (metrics["packaged_bytes"] != 11445104
            or metrics["msg_bytes"] != 44695848
            or opt.fault_stats["fused_sync_encodes"] != steps):
        fail(f"overlap fused byte metrics {metrics}, fault_stats "
             f"{opt.fault_stats}")
    check_params_finite(opt, "overlap fused blockq")
    ms = seconds / TIMED * 1e3
    print(f"[overlap] fused blockq ResNet-18 bf16 batch {BATCH}: {ms:.3f} "
          f"ms/step, {BATCH * TIMED / seconds:.1f} images/s per GPU "
          f"({TIMED} queued steps; the bucketed blockq run above: "
          f"{bucketed_ms:.3f} ms/step)")
    turns = [(queued_ms(bucketed, batch, TIMED), queued_ms(opt, batch, TIMED))
             for _ in range(2)]
    print(f"[overlap] in turns, {TIMED} queued steps each, bucketed vs fused "
          f"overlap blockq ms/step: "
          + "; ".join(f"{b:.3f} vs {f:.3f}" for b, f in turns))
    return opt


def run_overlap_unfused(named, aux, loss_fn, batch, group):
    """ResNet-18 through the overlap engine, unfused: blockq (one
    block_quantize launch per leaf; launch counts, losses, ms/step and the
    profile), then a few bf16 steps (one grouped cast_sum a step)."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    per_step = len(named)
    opt, losses, counts, seconds, _ = drive(
        "blockq", named, loss_fn, batch, group, OVERLAP_SIDE,
        OVERLAP_SIDE_TIMED, lr=0.1, has_aux=True, aux=aux,
        sync_mode="overlap")
    steps = OVERLAP_SIDE + OVERLAP_SIDE_TIMED
    dq_step = ck.group_launches("block_dequant_sum", per_step)
    print(f"[overlap] unfused blockq: losses {losses}, launches {counts} "
          f"(expect {per_step}/step of block_quantize and {dq_step}/step of "
          f"block_dequant_sum); {seconds / OVERLAP_SIDE_TIMED * 1e3:.3f} "
          f"ms/step ({OVERLAP_SIDE_TIMED} queued steps)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"overlap unfused blockq losses {losses}")
    expect_counts("ResNet-18 overlap blockq", counts,
                  block_quantize=per_step * steps,
                  block_dequant_sum=dq_step * steps)
    check_params_finite(opt, "overlap blockq")
    profile_steps(opt, batch, "ResNet-18 overlap blockq (unfused)")
    del opt

    opt, losses, counts, _, _ = drive(
        "bf16", named, loss_fn, batch, group, OVERLAP_SIDE, 0, lr=0.1,
        has_aux=True, aux=aux, sync_mode="overlap")
    cast_step = ck.group_launches("cast_sum", per_step)
    print(f"[overlap] bf16: losses {losses}, launches {counts} (expect "
          f"{cast_step}/step of cast_sum: the {per_step} leaves grouped)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"overlap bf16 losses {losses}")
    expect_counts("ResNet-18 overlap bf16", counts,
                  cast_sum=cast_step * OVERLAP_SIDE)
    check_params_finite(opt, "overlap bf16")
    del opt
    torch.cuda.empty_cache()


def _max_diff(a, b) -> float:
    return max(abs_err(a[n], b[n]) for n in a)


def compare_overlap_and_profile(named, aux, loss_fn, batch, group):
    """With cuDNN's deterministic algorithms: two bucketed identity runs
    give the card's run-to-run difference; the overlap engine's identity
    runs (rs_ag, psum: at world 1 the sums are the identity) must be no
    further from the first than that.  Then a profiled run of bucketed and
    of fused overlap blockq against the unprofiled run from the same
    start, within the same difference; the profiled step's phase split is
    printed."""
    import torch

    common = dict(lr=0.1, has_aux=True, aux=aux)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for what, code, options in (
                ("bucketed identity", "identity", {}),
                ("bucketed identity again", "identity", {}),
                ("overlap identity rs_ag", "identity",
                 dict(sync_mode="overlap")),
                ("overlap identity psum", "identity",
                 dict(sync_mode="overlap", overlap_reducer="psum")),
                ("bucketed blockq", "blockq", {}),
                ("bucketed blockq profiled", "blockq", dict(profile=True)),
                ("overlap fused blockq", "blockq",
                 dict(sync_mode="overlap", fused_encode=True)),
                ("overlap fused blockq profiled", "blockq",
                 dict(sync_mode="overlap", fused_encode=True,
                      profile=True))):
            opt, losses, counts, _, metrics = drive(
                code, named, loss_fn, batch, group, COMPARE_STEPS, 0,
                **common, **options)
            runs[what] = (losses, dict(opt.params), metrics)
            if code == "identity":
                expect_counts(what, counts)
            if not all(math.isfinite(v) for v in losses):
                fail(f"{what}: losses {losses}")
            del opt
    finally:
        torch.backends.cudnn.deterministic = deterministic
    base = runs["bucketed identity"]
    spread = _max_diff(base[1], runs["bucketed identity again"][1])
    loss_spread = max(abs(a - b) for a, b in zip(
        base[0], runs["bucketed identity again"][0]))
    print(f"[overlap] {COMPARE_STEPS} identity steps, cuDNN deterministic: "
          f"two bucketed runs differ by {spread} (params), {loss_spread} "
          f"(losses)")
    for what, ref in (("overlap identity rs_ag", "bucketed identity"),
                      ("overlap identity psum", "bucketed identity"),
                      ("bucketed blockq profiled", "bucketed blockq"),
                      ("overlap fused blockq profiled",
                       "overlap fused blockq")):
        d = _max_diff(runs[what][1], runs[ref][1])
        dl = max(abs(a - b) for a, b in zip(runs[what][0], runs[ref][0]))
        print(f"[overlap] {what} vs {ref}: max param diff {d}, max loss "
              f"diff {dl}")
        if d > max(spread, 0.0) or dl > max(loss_spread, 0.0):
            fail(f"{what} is further from {ref} than two bucketed runs "
                 f"from each other")
    for what in ("bucketed blockq profiled", "overlap fused blockq profiled"):
        m = runs[what][2]
        print(f"[overlap] phase split, {what} (step {COMPARE_STEPS}, ms): "
              + ", ".join(f"{k} {m[k] * 1e3:.3f}" for k in (
                  "backward_time", "code_wait", "isend_time", "comm_wait",
                  "decode_time", "optim_step_time")))


# ---------------------------------------------------------------------------
# Phase 3b: the step's features (codecs, EF, ZeRO, EMA, consensus, state)
# ---------------------------------------------------------------------------

# Each feature run: blocking warm-up steps, then queued timed steps.
FEATURE_WARM, FEATURE_TIMED = 2, 2
FEATURE_STEPS = FEATURE_WARM + FEATURE_TIMED
# Kernels a profiled step of the same runs before the element-order
# repair (PERF.md §5).
KERNELS_BEFORE_REPAIR = {"ResNet-18 blockq": 1195,
                         "ResNet-18 overlap fused blockq": 1171}


def print_kernels_a_step(measured):
    """Kernels a step (``measured``: label -> count, None if not measured)
    of the bucketed and fused blockq runs beside those before the
    element-order repair, which copies each permuted leaf where the
    codec's input was a view (f32 leaves; the bf16 ResNet's cast to f32
    already copies) and each permuted leaf of a fused bucket."""
    for what, before in KERNELS_BEFORE_REPAIR.items():
        now = measured[what]
        print(f"[features] kernels a step, {what}: "
              f"{'not measured' if now is None else now} after the "
              f"element-order repair (before it: {before})")


def _falls(losses) -> bool:
    return (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0])


def run_codecs(named, aux, loss_fn, batch, group, cpu_group):
    """topk (1%), topk_approx, quantize and sign on ResNet-18: a few steps
    each, losses finite and falling, ``packaged_bytes`` the sum of the
    codec's ``wire_bytes``, no codec kernel launched (their decodes are
    plain PyTorch, as their JAX counterparts are jnp); then the small
    MLP card against CPU with each."""
    from pytorch_ps_mpi_tpu_torch.ops.codecs import get_codec

    for code in ("topk", "topk_approx", "quantize", "sign"):
        opt, losses, counts, seconds, metrics = drive(
            code, named, loss_fn, batch, group, FEATURE_WARM, FEATURE_TIMED,
            lr=0.1, has_aux=True, aux=aux)
        wire = sum(get_codec(code).wire_bytes(p.shape, p.dtype)
                   for p in named.values())
        print(f"[features] {code}: losses {losses}, packaged_bytes "
              f"{metrics['packaged_bytes']:.0f} (sum of wire_bytes {wire}), "
              f"launches {counts}, {seconds / FEATURE_TIMED * 1e3:.3f} "
              f"ms/step ({FEATURE_TIMED} queued steps)")
        if not _falls(losses):
            fail(f"{code}: losses must be finite and fall: {losses}")
        if metrics["packaged_bytes"] != wire:
            fail(f"{code}: packaged_bytes {metrics['packaged_bytes']} != "
                 f"{wire}")
        expect_counts(f"ResNet-18 {code}", counts)
        check_params_finite(opt, code)
        del opt
    for code in ("topk", "topk_approx", "quantize", "sign"):
        small_reference_check(group, cpu_group, code=code)


def run_ef_zero_ema(named, aux, loss_fn, batch, group):
    """Blockq with error feedback (62 block_quantize and 2 grouped
    block_dequant_sum launches a step: the own codes' decode and the
    sum's), ZeRO with the identity codec (bucketed reduce-scatter) and
    with blockq, and bf16 with ZeRO and EMA (one grouped cast_sum a step)
    and the consensus guard every 2 steps."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    per_step = len(named)
    dq_step = ck.group_launches("block_dequant_sum", per_step)
    cast_step = ck.group_launches("cast_sum", per_step)
    common = dict(lr=0.1, has_aux=True, aux=aux)
    runs = (
        ("blockq + error_feedback", "blockq", dict(error_feedback=True),
         dict(block_quantize=per_step, block_dequant_sum=2 * dq_step)),
        ("zero identity", "identity", dict(zero=True), {}),
        ("zero blockq", "blockq", dict(zero=True),
         dict(block_quantize=per_step, block_dequant_sum=dq_step)),
        ("bf16 + zero + ema 0.999 + consensus_every=2", "bf16",
         dict(zero=True, ema_decay=0.999, consensus_every=2),
         dict(cast_sum=cast_step)))
    for what, code, options, per in runs:
        opt, losses, counts, seconds, metrics = drive(
            code, named, loss_fn, batch, group, FEATURE_WARM, FEATURE_TIMED,
            **common, **options)
        print(f"[features] {what}: losses {losses}, launches {counts}, "
              f"{seconds / FEATURE_TIMED * 1e3:.3f} ms/step "
              f"({FEATURE_TIMED} queued steps)")
        if not _falls(losses):
            fail(f"{what}: losses must be finite and fall: {losses}")
        expect_counts(f"ResNet-18 {what}", counts,
                      **{k: v * FEATURE_STEPS for k, v in per.items()})
        check_params_finite(opt, what)
        if options.get("error_feedback"):
            ef = opt.ef_state
            worst = max(float(v.abs().max()) for v in ef.values())
            print(f"[features] EF residual: {len(ef)} leaves [1, ...] f32, "
                  f"max |residual| {worst}")
            if not math.isfinite(worst) or worst == 0.0:
                fail(f"EF residual max {worst}")
        if options.get("zero"):
            shard = sum(v.numel() for st in opt.state.values()
                        for v in st.values() if v.dim() == 1)
            print(f"[features] zero: this rank's state holds {shard} "
                  f"elements (world 1: every chunk)")
        if "ema_decay" in options:
            fs = opt.fault_stats
            print(f"[features] ema: {len(opt.ema_params)} leaves; consensus "
                  f"checks {fs['sdc_checks']}, mismatches "
                  f"{fs['sdc_mismatches']}")
            if fs["sdc_checks"] != FEATURE_STEPS // 2 or fs["sdc_mismatches"]:
                fail(f"consensus guard: {fs}")
            for n, e in opt.ema_params.items():
                if not bool(torch.isfinite(e).all()):
                    fail(f"EMA {n} is not finite")
        del opt


def check_state_round_trip(named, aux, loss_fn, batch, group):
    """3 steps, `state_dict`, a fresh optimizer loads it and takes 2 more,
    against 5 steps in one run (blockq, error feedback, ZeRO, EMA), under
    cuDNN's deterministic algorithms: params, EMA, EF residual and
    BatchNorm statistics must agree to 0.0."""
    import torch

    from pytorch_ps_mpi_tpu_torch import SGD

    options = dict(code="blockq", error_feedback=True, zero=True,
                   ema_decay=0.999)

    def fresh():
        opt = SGD(list(named.items()), lr=0.1, momentum=0.9, device="cuda",
                  group=group, **options)
        opt.compile_step(loss_fn, has_aux=True, aux=aux)
        return opt

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        whole = fresh()
        for _ in range(5):
            whole.step(batch)
        first = fresh()
        for _ in range(3):
            first.step(batch)
        t0 = time.perf_counter()
        sd = first.state_dict()
        save_s = time.perf_counter() - t0
        del first
        resumed = fresh()
        t0 = time.perf_counter()
        resumed.load_state_dict(sd)
        load_s = time.perf_counter() - t0
        for _ in range(2):
            resumed.step(batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = max(_max_diff(whole.params, resumed.params),
               _max_diff(whole.ema_params, resumed.ema_params),
               _max_diff(whole.extras["ef"], resumed.extras["ef"]),
               _max_diff(whole.aux, resumed.aux))
    print(f"[features] state_dict round trip (blockq, EF, ZeRO, EMA; 3 + 2 "
          f"steps against 5, cuDNN deterministic): max difference {diff} "
          f"over params, EMA, EF residual and BatchNorm statistics; "
          f"state_dict {save_s * 1e3:.1f} ms, load_state_dict "
          f"{load_s * 1e3:.1f} ms")
    if diff != 0.0:
        fail(f"state_dict round trip differs by {diff}")


def run_features(named, aux, loss_fn, batch, group, cpu_group):
    run_codecs(named, aux, loss_fn, batch, group, cpu_group)
    run_ef_zero_ema(named, aux, loss_fn, batch, group)
    check_state_round_trip(named, aux, loss_fn, batch, group)


# ---------------------------------------------------------------------------
# Phase 4: the transformer LM
# ---------------------------------------------------------------------------

# The bench LM (`bench.py::worker_lm_throughput`): full width and depth.
LM = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=12,
          d_ff=4096, max_len=1024)
LM_BATCH, LM_SEQ = 16, 1024
LM_WARM, LM_TIMED, LM_BLOCKQ = 2, 5, 2
LM_OVERLAP_WARM, LM_OVERLAP_TIMED = 2, 3
LM_TENSORS, LM_PARAMS = 150, 219346944
LM_MSG_BYTES, LM_BLOCKQ_BYTES = 877387776, 219360716


def time_lm_head_gemms(named):
    """The f32 lm_head GEMMs of one step at the LM's shapes, CUDA events:
    forward ``x @ W^T``, dgrad ``dlogits @ W`` and wgrad ``dlogits^T @
    x``, with TF32 off as the run sets it."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = LM_BATCH * LM_SEQ
    w = named["lm_head.weight"].cuda()
    x = torch.randn(rows, LM["d_model"], device="cuda", generator=gen)
    g = torch.randn(rows, LM["vocab_size"], device="cuda", generator=gen)
    out = {"forward": time_ms(lambda: x @ w.t(), reps=5),
           "dgrad": time_ms(lambda: g @ w, reps=5),
           "wgrad": time_ms(lambda: g.t() @ x, reps=5)}
    flops = 2 * rows * LM["d_model"] * LM["vocab_size"]
    print(f"[lm] f32 lm_head GEMMs ({rows}x{LM['d_model']}x"
          f"{LM['vocab_size']}, TF32 off): "
          + ", ".join(f"{k} {v:.3f} ms ({flops / v / 1e9:.1f} TFLOP/s)"
                      for k, v in out.items())
          + f"; {sum(out.values()):.3f} ms per step")
    return out


def time_fingerprint(opt):
    """The replica-consensus guard on the LM's 219M parameters: the
    fingerprint (a wrapping sum and an xor-fold of every leaf's bits) and
    the cross-rank compare, host clock to the host's read of the result,
    three times after one warm-up."""
    import torch

    opt.check_consensus()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = opt.check_consensus()
        times.append((time.perf_counter() - t0) * 1e3)
    if not out["ok"]:
        fail(f"consensus guard on one rank: {out}")
    print(f"[lm] consensus guard (fingerprint of {LM_PARAMS} parameters in "
          f"{LM_TENSORS} leaves and the compare): "
          + ", ".join(f"{t:.3f}" for t in times) + " ms")


def run_lm_remat(named, loss_fn, batch, group, plain_peak):
    """The bench LM with ``accum_steps=4, remat=True`` (identity): 4
    microbatches of 4 x 1024 tokens a step, each layer's forward run again
    in backward, so flash_fwd launches 2 x 12 x 4 = 96 times a step and
    each backward kernel 48; peak memory against the plain step's."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt, losses, counts, seconds, _ = drive(
        "identity", named, loss_fn, batch, group, 1, 2, lr=0.01,
        compile_kw=dict(accum_steps=4, remat=True))
    steps = 3
    per_step = LM["n_layers"] * 4
    print(f"[lm] accum_steps=4, remat=True: losses {losses}, launches "
          f"{counts}; {seconds / 2 * 1e3:.3f} ms/step (2 queued steps); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"against {plain_peak / 2**30:.2f} GiB for the plain step")
    if not _falls(losses):
        fail(f"LM remat losses must be finite and fall: {losses}")
    expect_counts("LM accum_steps=4 remat", counts,
                  flash_fwd=2 * per_step * steps,
                  flash_bwd_dkdv=per_step * steps,
                  flash_bwd_dq=per_step * steps)
    check_params_finite(opt, "LM remat")
    profile_steps(opt, batch, "LM accum_steps=4 remat", steps=1)
    del opt
    torch.cuda.empty_cache()


def small_lm_reference_check(group, cpu_group):
    """A small LM (d_model 64, 4 heads of 16, 2 layers, S=160 so the
    64-row tiles end ragged) in f32 trained 3 SGD steps on the card (flash
    kernels, head dim padded to 64) and on the CPU (plain versions), from
    the same weights and tokens.  Tolerance rtol=1e-4, atol=1e-5: float32
    throughout with TF32 off; the kernels' FMA chains, cuBLAS and the CPU
    sum in other orders, and three steps of momentum carry that forward."""
    import functools

    from pytorch_ps_mpi_tpu_torch import SGD, flash_attention
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_lm
    from pytorch_ps_mpi_tpu_torch.models import (TransformerLM, build_lm,
                                                 lm_batch, make_lm_loss)

    cfg = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_len=256)
    model = TransformerLM(**cfg, attn=functools.partial(flash_attention,
                                                        causal=True))
    named = build_lm(model, seed=3)
    batch = lm_batch(synthetic_lm(4, seq_len=160, vocab=97, seed=4))
    out = {}
    for device, grp in (("cuda", group), ("cpu", cpu_group)):
        opt = SGD(list(named.items()), lr=0.05, momentum=0.9, device=device,
                  group=grp)
        opt.compile_step(make_lm_loss(model))
        reset_launch_counts()
        losses = [opt.step(batch)[0] for _ in range(3)]
        counts = launch_counts()
        want = 3 * cfg["n_layers"] if device == "cuda" else 0
        expect_counts(f"small LM on {device}", counts, flash_fwd=want,
                      flash_bwd_dkdv=want, flash_bwd_dq=want)
        out[device] = (losses, {n: p.cpu().numpy()
                                for n, p in opt.params.items()})
    _assert_close_runs("small LM f32 identity", out, 1e-4, 1e-5)


def run_lm(group, cpu_group):
    """The bench LM through the public entry points, identity codec (the
    bench's), then two blockq steps; returns each flash kernel's launches
    in the identity run."""
    import functools

    import torch

    from pytorch_ps_mpi_tpu_torch import flash_attention
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_lm
    from pytorch_ps_mpi_tpu_torch.models import (TransformerLM, build_lm,
                                                 lm_batch, make_lm_loss)
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    model = TransformerLM(**LM, dtype=torch.bfloat16,
                          attn=functools.partial(flash_attention, causal=True))
    t0 = time.perf_counter()
    named = build_lm(model, seed=0)
    n_params = sum(p.numel() for p in named.values())
    print(f"[lm] TransformerLM {LM} bf16, flash attention: {len(named)} "
          f"tensors, {n_params} parameters (init {time.perf_counter() - t0:.1f}"
          f" s on the host)")
    if len(named) != LM_TENSORS or n_params != LM_PARAMS:
        fail(f"the bench LM has {len(named)} tensors and {n_params} "
             f"parameters, expected {LM_TENSORS} and {LM_PARAMS}")
    toks = synthetic_lm(LM_BATCH, seq_len=LM_SEQ, vocab=LM["vocab_size"],
                        seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in lm_batch(toks).items()}
    loss_fn = make_lm_loss(model)
    per_step = LM["n_layers"]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt, losses, counts, seconds, metrics = drive(
        "identity", named, loss_fn, batch, group, LM_WARM, LM_TIMED, lr=0.01)
    steps = LM_WARM + LM_TIMED
    print(f"[lm] identity: {steps} steps, losses {losses}, launches {counts}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"LM losses must be finite and fall: {losses}")
    expect_counts("LM identity", counts, flash_fwd=per_step * steps,
                  flash_bwd_dkdv=per_step * steps,
                  flash_bwd_dq=per_step * steps)
    if (metrics["msg_bytes"] != LM_MSG_BYTES
            or metrics["packaged_bytes"] != LM_MSG_BYTES):
        fail(f"LM byte metrics {metrics}")
    check_params_finite(opt, "LM identity")
    ms = seconds / LM_TIMED * 1e3
    PHASE4["ms"] = ms
    tokens = LM_BATCH * LM_SEQ
    print(f"[lm] bench LM bf16 batch {LM_BATCH} x seq {LM_SEQ}: {ms:.3f} "
          f"ms/step, {tokens * LM_TIMED / seconds:.1f} tokens/s per GPU "
          f"({LM_TIMED} queued steps, host clock to synchronize); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    plain_peak = torch.cuda.max_memory_allocated()
    lm_counts = counts
    bucketed = opt
    time_fingerprint(bucketed)

    opt, losses, counts, seconds, metrics = drive(
        "identity", named, loss_fn, batch, group, LM_OVERLAP_WARM,
        LM_OVERLAP_TIMED, lr=0.01, sync_mode="overlap")
    steps = LM_OVERLAP_WARM + LM_OVERLAP_TIMED
    print(f"[lm] overlap identity (rs_ag, {opt.overlap_plan.n_buckets} "
          f"buckets): {steps} steps, losses {losses}, launches {counts}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"LM overlap losses {losses}")
    expect_counts("LM overlap identity", counts, flash_fwd=per_step * steps,
                  flash_bwd_dkdv=per_step * steps,
                  flash_bwd_dq=per_step * steps)
    if metrics["msg_bytes"] != LM_MSG_BYTES:
        fail(f"LM overlap byte metrics {metrics}")
    check_params_finite(opt, "LM overlap identity")
    print(f"[lm] overlap identity: "
          f"{seconds / LM_OVERLAP_TIMED * 1e3:.3f} ms/step, "
          f"{tokens * LM_OVERLAP_TIMED / seconds:.1f} tokens/s per GPU "
          f"({LM_OVERLAP_TIMED} queued steps; bucketed above: {ms:.3f} "
          f"ms/step); in turns, {LM_OVERLAP_TIMED} queued steps each, "
          f"bucketed {queued_ms(bucketed, batch, LM_OVERLAP_TIMED):.3f} vs "
          f"overlap {queued_ms(opt, batch, LM_OVERLAP_TIMED):.3f} ms/step; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"with both optimizers held")
    del opt
    device_ms, _ = profile_steps(bucketed, batch, "LM identity")
    if device_ms is not None:
        print(f"[lm] device busy share without the profiler: "
              f"{device_ms / ms:.3f} (profiled device ms/step over the timed "
              f"ms/step)")
    del bucketed
    torch.cuda.empty_cache()

    opt, losses, counts, _, metrics = drive(
        "blockq", named, loss_fn, batch, group, LM_BLOCKQ, 0, lr=0.01)
    dq_step = ck.group_launches("block_dequant_sum", LM_TENSORS)
    print(f"[lm] blockq: losses {losses}, launches {counts} (expect "
          f"{LM_TENSORS}/step of block_quantize and {dq_step}/step of "
          f"block_dequant_sum: the {LM_TENSORS} leaves grouped), "
          f"packaged_bytes {metrics['packaged_bytes']:.0f}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"LM blockq losses {losses}")
    expect_counts("LM blockq", counts,
                  block_quantize=LM_TENSORS * LM_BLOCKQ,
                  block_dequant_sum=dq_step * LM_BLOCKQ,
                  flash_fwd=per_step * LM_BLOCKQ,
                  flash_bwd_dkdv=per_step * LM_BLOCKQ,
                  flash_bwd_dq=per_step * LM_BLOCKQ)
    if metrics["packaged_bytes"] != LM_BLOCKQ_BYTES:
        fail(f"LM blockq byte metrics {metrics}")
    check_params_finite(opt, "LM blockq")
    del opt
    torch.cuda.empty_cache()
    run_lm_remat(named, loss_fn, batch, group, plain_peak)
    time_lm_head_gemms(named)
    small_lm_reference_check(group, cpu_group)
    return {k: lm_counts[k] for k in FLASH_REPLACES}


# ---------------------------------------------------------------------------
# Phase 5: the training CLI on the card
# ---------------------------------------------------------------------------

# The CLI's ResNet-18 run, at the configuration of phase 3.
CLI_R18 = ["--model", "resnet18", "--dataset", "cifar10", "--bf16",
           "--codec", "blockq", "--batch-size", str(BATCH)]
CLI_R18_STEPS = 20
CLI_LM = ["--model", "transformer", "--attn", "flash", "--bf16",
          "--seq-len", "1024", "--vocab", "32768", "--batch-size", "16"]
CLI_LM_STEPS = 10
# A subprocess run sets the card's numerics as phase 3 does (TF32 off;
# cuDNN's deterministic algorithms where asked) and then calls the CLI's
# console entry point, `train.cli_entry`, with the remaining arguments.
_CLI_BOOT = (
    "import sys, torch\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.deterministic = sys.argv[1] == 'deterministic'\n"
    "from pytorch_ps_mpi_tpu_torch.train import cli_entry\n"
    "sys.argv = ['ps-torch-train'] + sys.argv[2:]\n"
    "cli_entry()\n")
_DONE = re.compile(r"^done: (\d+) steps, ([\d,.]+) (images|tokens)/sec",
                   re.M)
_STEP = re.compile(r"^step +(\d+)  loss (\S+)  comm_wait", re.M)


def cli_process(argv, *, deterministic=False, expect=0, timeout=600):
    """One CLI run in a process of its own; fails unless it exits with
    ``expect``.  Returns its stderr."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", _CLI_BOOT,
         "deterministic" if deterministic else "default", *argv],
        capture_output=True, text=True, timeout=timeout)
    print(f"[cli] process ({time.perf_counter() - t0:.1f} s, exit "
          f"{out.returncode}): ps-torch-train {' '.join(argv)}")
    for line in out.stderr.splitlines()[-12:]:
        print(f"[cli]   | {line}")
    if out.returncode != expect:
        print(out.stderr[-6000:], file=sys.stderr)
        fail(f"CLI exited {out.returncode}, expected {expect}: "
             f"{' '.join(argv)}")
    return out.stderr


def cli_in_process(argv, what):
    """One CLI run in this process (`train.main`, on the card and the
    phase's NCCL group) with the launch counts zeroed just before and read
    just after.  Returns (optimizer, stderr, counts)."""
    import contextlib
    import io

    from pytorch_ps_mpi_tpu_torch import train

    err = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        opt = train.main(list(argv))
    counts = launch_counts()
    print(f"[cli] in process ({time.perf_counter() - t0:.1f} s), {what}: "
          f"ps-torch-train {' '.join(argv)}")
    for line in err.getvalue().splitlines()[-6:]:
        print(f"[cli]   | {line}")
    return opt, err.getvalue(), counts


def _done(stderr, what) -> "tuple[int, float]":
    m = _DONE.search(stderr)
    if m is None:
        fail(f"{what}: no 'done:' line in the CLI's output")
    return int(m.group(1)), float(m.group(2).replace(",", ""))


def _losses(stderr, what) -> "list[float]":
    losses = [float(v) for _, v in _STEP.findall(stderr)]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"{what}: losses {losses}")
    return losses


def _steady_ms(opt) -> float:
    """Mean host time of the blocking steps after the first: dispatch plus
    the wait for the card (`isend_time` + `comm_wait`)."""
    rest = opt.timings[1:]
    return sum(t["isend_time"] + t["comm_wait"] for t in rest) \
        / len(rest) * 1e3


def _state_of(path):
    from pytorch_ps_mpi_tpu_torch.utils import checkpoint

    tree = checkpoint.load(path)
    return ({n: a for n, a in tree["params"].items()},
            {n: st["momentum_buffer"] for n, st in tree["state"].items()})


def _np_max_diff(a, b) -> float:
    import numpy as np

    if set(a) != set(b):
        fail(f"checkpoints hold other leaves: {sorted(set(a) ^ set(b))}")
    return max(float(np.abs(np.asarray(a[n], np.float64)
                            - np.asarray(b[n], np.float64)).max())
               for n in a)


def cli_resnet18(phase3_images_per_s, n_leaves):
    """The CLI's ResNet-18 blockq run in its own process (images/s beside
    phase 3's bucketed figure, losses finite and falling), and 3 steps in
    this process for the launch counts."""
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    argv = CLI_R18 + ["--n-examples", "8192", "--steps", str(CLI_R18_STEPS)]
    stderr = cli_process(argv)
    steps, ips = _done(stderr, "ResNet-18 CLI")
    losses = _losses(stderr, "ResNet-18 CLI")
    if steps != CLI_R18_STEPS or not losses[-1] < losses[0]:
        fail(f"ResNet-18 CLI: {steps} steps, losses {losses}")
    print(f"[cli] ResNet-18 bf16 blockq batch {BATCH}, {steps} steps: "
          f"{ips:.1f} images/s (the CLI's done line: every step blocks, the "
          f"first included, the loader's gather and host-to-device copy in "
          f"the loop) against phase 3's bucketed {phase3_images_per_s:.1f} "
          f"images/s (queued steps): ratio {ips / phase3_images_per_s:.3f}; "
          f"losses {losses}")
    opt, _, counts = cli_in_process(
        CLI_R18 + ["--n-examples", "2048", "--steps", "3"],
        "ResNet-18 launch counts")
    dq_step = ck.group_launches("block_dequant_sum", n_leaves)
    expect_counts("ResNet-18 CLI", counts, block_quantize=n_leaves * 3,
                  block_dequant_sum=dq_step * 3)
    print(f"[cli] ResNet-18 CLI launches in 3 steps: {counts} ({n_leaves} "
          f"block_quantize and {dq_step} block_dequant_sum a step); steady "
          f"step {_steady_ms(opt):.3f} ms (steps 2-3: dispatch + wait)")
    check_params_finite(opt, "ResNet-18 CLI")


def cli_resnet50():
    """ResNet-50 at full ImageNet width (224x224, 1000 classes), bf16,
    blockq, batch 256: one block_quantize a leaf a step, finite losses,
    images/s and peak memory."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = 6
    opt, stderr, counts = cli_in_process(
        ["--model", "resnet50", "--dataset", "imagenet", "--bf16", "--codec",
         "blockq", "--batch-size", "256", "--n-examples", "256", "--steps",
         str(steps)], "ResNet-50")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_leaves = len(opt.params)
    dq_step = ck.group_launches("block_dequant_sum", n_leaves)
    if n_leaves != 161:
        fail(f"ResNet-50 has {n_leaves} tensors, expected 161")
    expect_counts("ResNet-50 CLI", counts, block_quantize=n_leaves * steps,
                  block_dequant_sum=dq_step * steps)
    _losses(stderr, "ResNet-50 CLI")
    if not all(math.isfinite(t["comm_wait"]) for t in opt.timings):
        fail("ResNet-50 CLI timings")
    check_params_finite(opt, "ResNet-50 CLI")
    _, ips = _done(stderr, "ResNet-50 CLI")
    steady = _steady_ms(opt)
    print(f"[cli] ResNet-50 ImageNet bf16 blockq batch 256, {steps} steps: "
          f"{ips:.1f} images/s (done line, first step included); steady "
          f"step {steady:.3f} ms ({256 / steady * 1e3:.1f} images/s, steps "
          f"2-{steps}); peak memory {peak:.2f} GiB; launches {counts} "
          f"({n_leaves} block_quantize a step)")
    del opt
    torch.cuda.empty_cache()


def cli_lenet_bf16():
    opt, stderr, counts = cli_in_process(
        ["--model", "lenet", "--codec", "bf16", "--steps", "1"], "LeNet bf16")
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    expect_counts("LeNet bf16 CLI", counts,
                  cast_sum=ck.group_launches("cast_sum", len(opt.params)))
    _losses(stderr, "LeNet bf16 CLI")
    print(f"[cli] LeNet bf16 codec, 1 step: launches {counts}")


def cli_lm():
    """The CLI's LM (4 layers, d_model 256, 8 heads, vocab 32768, bf16,
    flash attention) at batch 16 x 1024: tokens/s from its own process, 4
    launches of each flash kernel a step from 2 steps in this one."""
    stderr = cli_process(CLI_LM + ["--steps", str(CLI_LM_STEPS)])
    steps, tok_s = _done(stderr, "LM CLI")
    losses = _losses(stderr, "LM CLI")
    opt, _, counts = cli_in_process(CLI_LM + ["--steps", "2"],
                                    "LM launch counts")
    expect_counts("LM CLI", counts, flash_fwd=8, flash_bwd_dkdv=8,
                  flash_bwd_dq=8)
    check_params_finite(opt, "LM CLI")
    print(f"[cli] LM bf16 flash batch 16 x 1024, {steps} steps: {tok_s:.0f} "
          f"tokens/s (done line); losses {losses}; steady step "
          f"{_steady_ms(opt):.3f} ms (step 2); launches in 2 steps {counts}")
    profile_cli_lm(opt)
    del opt


def profile_cli_lm(opt):
    """Where the CLI LM's step goes, on the CLI's own optimizer after its
    launch counts were read: the device time by category of two queued
    steps, then the phase split of a step under ``profile=True`` (each
    phase run to a synchronize; the second of two, so warm)."""
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_lm
    from pytorch_ps_mpi_tpu_torch.models.transformer import lm_batch

    batch = lm_batch(synthetic_lm(16, seq_len=1024, vocab=32768, seed=0))
    profile_steps(opt, batch, "CLI LM")
    opt.profile = True
    for _ in range(2):
        opt.step(batch)
    opt.profile = False
    m = opt.timings[-1]
    print("[cli] LM phase split (profile=True, ms): "
          + ", ".join(f"{k} {m[k] * 1e3:.3f}" for k in (
              "backward_time", "code_wait", "isend_time", "comm_wait",
              "decode_time", "optim_step_time")))


def cli_preempt_and_resume(tmp):
    """ResNet-18 blockq under cuDNN's deterministic algorithms: a run
    preempted by a real SIGTERM (exit 75, a RESUMABLE step-tagged file),
    resumed to the end, against one straight run: params and momentum
    equal to 0.0.  Then save_optimizer and load_optimizer timed on the
    card."""
    import os

    import torch

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.models import (build_model,
                                                 make_classifier_loss,
                                                 resnet18)
    from pytorch_ps_mpi_tpu_torch.utils import checkpoint

    ck_path = os.path.join(tmp, "ck.psz")
    straight = os.path.join(tmp, "straight.psz")
    base = CLI_R18 + ["--steps", "6"]
    cli_process(base + ["--save", ck_path, "--save-every", "3", "--chaos",
                        json.dumps({"preempt_at_step": 4})],
                deterministic=True, expect=75)
    latest = checkpoint.latest_checkpoint(ck_path)
    if (latest != checkpoint.step_path(ck_path, 5)
            or not checkpoint.is_resumable(latest)):
        fail(f"preempted run left {latest} (RESUMABLE: "
             f"{latest and checkpoint.is_resumable(latest)})")
    cli_process(base + ["--resume", ck_path, "--save", ck_path],
                deterministic=True)
    cli_process(base + ["--save", straight], deterministic=True)
    params, momentum = _state_of(ck_path)
    params0, momentum0 = _state_of(straight)
    diff = max(_np_max_diff(params, params0),
               _np_max_diff(momentum, momentum0))
    print(f"[cli] preempted at step 5 (exit 75, RESUMABLE "
          f"{os.path.basename(latest)}) + resumed to 6 against 6 straight "
          f"steps, cuDNN deterministic: max difference {diff} over params "
          f"and momentum")
    if diff != 0.0:
        fail(f"preempt + resume differs from the straight run by {diff}")

    model = resnet18(num_classes=10, small_inputs=True, dtype=torch.bfloat16)
    named, aux = build_model(model, seed=0)
    loss_fn, _ = make_classifier_loss(model)
    opt = SGD(list(named.items()), lr=0.01, momentum=0.9, code="blockq",
              device="cuda")
    opt.compile_step(loss_fn, has_aux=True, aux=aux)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.load_optimizer(ck_path, opt)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    again = os.path.join(tmp, "again.psz")
    t0 = time.perf_counter()
    checkpoint.save_optimizer(again, opt, step=6)
    save_ms = (time.perf_counter() - t0) * 1e3
    mb = os.path.getsize(ck_path) / 1e6
    print(f"[cli] ResNet-18 checkpoint: {mb:.2f} MB on disk (level 1: "
          f"shuffle + LZ); save_optimizer {save_ms:.1f} ms, load_optimizer "
          f"{load_ms:.1f} ms (the card's state to and from the file)")
    del opt


def cli_guard_rollback(tmp):
    """A loss spike at step 13 (after the guard's 8-loss history) rolls the
    run back once, to the step-12 checkpoint, and it completes.  The run
    is the CLI's MLP with blockq at batch 1024: the spike scales the
    inputs by 1e4 and rotates the labels, and a ResNet's first BatchNorm
    normalises the scaling away, leaving a rotation that a 12-step
    ResNet's loss absorbs below the guard's threshold."""
    import os

    opt, stderr, counts = cli_in_process(
        ["--model", "mlp", "--codec", "blockq", "--batch-size", str(BATCH),
         "--n-examples", "8192", "--steps", "16", "--chaos",
         json.dumps({"spike_at_step": 12}), "--guard-spike-mad", "6",
         "--save", os.path.join(tmp, "ck2.psz"), "--save-every", "4"],
        "divergence guard")
    events = [e for e in opt.fault_stats["rollbacks"]
              if e.get("restored_step") is not None]
    print(f"[cli] divergence guard: rollbacks "
          f"{[(e['step'], e['reason'], e['restored_step']) for e in events]}"
          f", launches {counts}")
    if len(events) != 1 or events[0]["restored_step"] != 12:
        fail(f"expected one rollback to step 12: "
             f"{opt.fault_stats['rollbacks']}")
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    calls = opt.steps_completed  # 16 steps and the rolled-back one
    if calls != 17:
        fail(f"guard run took {calls} steps, expected 17")
    expect_counts("MLP guard CLI", counts, block_quantize=4 * calls,
                  block_dequant_sum=ck.group_launches("block_dequant_sum", 4)
                  * calls)
    check_params_finite(opt, "guard rollback")
    del opt


def cli_card_vs_cpu(tmp):
    """The CLI's MLP with blockq on the card (this process) and on the CPU
    (`--force-cpu-devices 1`, its own process): params within phase 3's
    rtol 1e-4 / atol 1e-5, with at most one element in 10,000 outside (a
    code one quantum apart; such a flip then spreads to the next steps'
    gradients, so 2 steps, as in the CPU tests)."""
    import os

    import numpy as np

    card, cpu = os.path.join(tmp, "card.psz"), os.path.join(tmp, "cpu.psz")
    argv = ["--model", "mlp", "--codec", "blockq", "--steps", "2",
            "--batch-size", "64", "--n-examples", "256"]
    cli_in_process(argv + ["--save", card], "MLP blockq on the card")
    cli_process(argv + ["--save", cpu, "--force-cpu-devices", "1"])
    a, _ = _state_of(card)
    b, _ = _state_of(cpu)
    outside = sum(int((~np.isclose(a[n], b[n], rtol=1e-4, atol=1e-5)).sum())
                  for n in b)
    total = sum(v.size for v in b.values())
    print(f"[cli] MLP blockq, card vs CPU (2 steps): max difference "
          f"{_np_max_diff(a, b)}, {outside} of {total} elements outside "
          f"rtol 1e-4 / atol 1e-5")
    if outside > 1e-4 * total:
        fail(f"MLP card vs CPU: {outside} of {total} elements apart")


# ---------------------------------------------------------------------------
# Phase 6: the in-process async PS on the card
# ---------------------------------------------------------------------------

# `bench.py::worker_async_resnet18`: ResNet-18 bf16, batch 512, synthetic
# CIFAR-10 of 8,192 examples, AsyncSGD(lr=0.02, momentum=0.9), 4 warm-up
# updates and 40 timed ones.
ASYNC_BATCH, ASYNC_EXAMPLES = 512, 8192
ASYNC_WARM, ASYNC_TIMED = 4, 40
ASYNC_LR = 0.02
# The four-worker runs: a PS and four worker threads on one card.  A fill
# SUMS its quota of gradients (the reference's contract), so lr / quota
# keeps run 1's step per gradient.
ASYNC_WORKERS, ASYNC_QUOTA = 4, 4
# Run 3 takes the bench's 40 timed updates too: against a sign-flipping
# rank the loss stalls or climbs for a few updates near update 10-17 on
# its way down, where a 20-update run's last fifth falls.
ASYNC_ROBUST_UPDATES = ASYNC_TIMED
ASYNC_LM_STEPS = 10


def _async_resnet18():
    """Run 1-3's model: ResNet-18 bf16 with BatchNorm in evaluation mode on
    its initial statistics (the async PS's plain-params contract, as the
    JAX bench runs it), its loss (a module copy a worker thread), and the
    batch function of its synthetic CIFAR-10."""
    import torch
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch.async_ps import dataset_batch_fn
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_cifar10
    from pytorch_ps_mpi_tpu_torch.models import (build_model, cross_entropy,
                                                 per_thread, resnet18)

    model = resnet18(num_classes=10, small_inputs=True, dtype=torch.bfloat16)
    named, aux = build_model(model, seed=0)
    module = per_thread(model.eval())
    stats = {n: t.to("cuda") for n, t in aux.items()}

    def loss_fn(params_named, batch):
        logits = functional_call(module(), {**params_named, **stats},
                                 (batch["x"],))
        return cross_entropy(logits, batch["y"])

    x, y = synthetic_cifar10(ASYNC_EXAMPLES, seed=0)
    return named, loss_fn, dataset_batch_fn(x, y, ASYNC_BATCH)


def _fifths(losses) -> "tuple[float, float]":
    k = max(1, len(losses) // 5)
    return (sum(losses[:k]) / k, sum(losses[-k:]) / k)


def async_run(what, named, loss_fn, batch_fn, *, updates, warm=0,
              devices=None, **kw):
    """``warm`` updates (cuDNN's algorithm choice, the allocator, the
    threads), then ``updates`` timed ones of ``AsyncSGD(momentum=0.9)`` —
    the launch counts zeroed just before the timed run and read just
    after.  Fails on non-finite params or a loss that does not fall
    (first fifth of the updates against the last).  Returns (optimizer,
    history, counts, images/s)."""
    import torch

    from pytorch_ps_mpi_tpu_torch import AsyncSGD

    devices = devices or [torch.device("cuda")]
    opt = AsyncSGD(list(named.items()), momentum=0.9, devices=devices, **kw)
    opt.compile_step(loss_fn)
    if warm:
        opt.run(batch_fn, steps=warm)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    hist = opt.run(batch_fn, steps=updates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_params_finite(opt, what)
    first, last = _fifths(hist["losses"])
    if not all(math.isfinite(v) for v in hist["losses"]) or not last < first:
        fail(f"{what}: losses {hist['losses']}")
    ips = hist["grads_consumed"] * ASYNC_BATCH / wall
    print(f"[async] {what}: {updates} updates, {hist['grads_consumed']} "
          f"grads ({hist['grads_computed']} computed), {ips:.1f} images/s, "
          f"loss first/last fifth {first:.4f} / {last:.4f}, staleness mean "
          f"{sum(hist['staleness']) / len(hist['staleness']):.3f} max "
          f"{max(hist['staleness']):.3f}, workers {opt.num_workers}, "
          f"quota {opt.quota}; launches {counts}")
    return opt, hist, counts, ips


def _expect_async_counts(what, hist, counts, code, leaves, decodes):
    """Under blockq each computed gradient quantizes its ``leaves`` leaves
    (a ``block_quantize`` launch each) and each of the run's ``decodes``
    grouped decodes (one a linear fill, one a contribution on the robust
    path) takes its ``block_dequant_sum`` launches; under bf16 each decode
    takes its ``cast_sum`` launches; identity launches nothing."""
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    want = {}
    if code == "blockq":
        want = dict(block_quantize=leaves * hist["grads_computed"],
                    block_dequant_sum=decodes * ck.group_launches(
                        "block_dequant_sum", leaves))
    elif code == "bf16":
        want = dict(cast_sum=decodes * ck.group_launches("cast_sum", leaves))
    expect_counts(what, counts, **want)


def profile_async(opt, batch_fn, what, updates: int = 2):
    """The card's busy share while ``updates`` updates run: the union of
    the CUDA kernels' intervals (the worker streams overlap) over the host
    time to synchronize, from torch.profiler, and the summed kernel time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.run(batch_fn, steps=updates)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"[async] {what}: the profiler saw no CUDA kernels: busy "
              f"share not measured")
        return None
    union, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    kernel_us = sum(b - a for a, b in spans)
    print(f"[async] {what}, {updates} updates under the profiler: wall "
          f"{wall_us / 1e3:.3f} ms, device busy (union of kernels) "
          f"{union / 1e3:.3f} ms, busy share {union / wall_us:.3f}; kernel "
          f"time summed over streams {kernel_us / 1e3:.3f} ms, "
          f"{len(spans)} kernels")
    return union / wall_us


def async_cli_lm(tmp):
    """Run 4: the CLI's async LM (``--async-ps``, bf16, flash attention,
    blockq; batch 16 x 1024) in a process of its own, saving at update 10;
    then in this process a resume at ``--steps 10`` (nothing to train: the
    params must equal the file's, to 0.0) and one to update 12 with the
    launch counts read around it (4 of each flash kernel and a
    ``block_quantize`` a leaf per computed gradient, one decode a
    fill)."""
    import os

    import torch

    ck = os.path.join(tmp, "async_lm.psz")
    argv = ["--async-ps"] + CLI_LM + ["--codec", "blockq"]
    stderr = cli_process(argv + ["--steps", str(ASYNC_LM_STEPS), "--save",
                                 ck])
    m = re.search(r"^done: (\d+) updates, (\d+) grads, ([\d.]+) images/sec,"
                  r" mean staleness ([\d.]+)$", stderr, re.M)
    if m is None or "async PS: 1 workers, quota 1" not in stderr:
        fail("async LM CLI: no 'async PS:' or 'done:' line")
    rows_s = float(m.group(3))
    print(f"[async] LM CLI (run 4): {m.group(1)} updates, {m.group(2)} "
          f"grads, {rows_s * 1024:.0f} tokens/s ({rows_s:.1f} rows/s on "
          f"the done line), mean staleness {m.group(4)}")
    saved, _ = _state_of(ck)
    opt, err, _ = cli_in_process(
        argv + ["--steps", str(ASYNC_LM_STEPS), "--resume", ck],
        "async LM resumed at its own step")
    if "nothing to do" not in err or opt.timings:
        fail("async LM resume at --steps 10 trained")
    start_diff = _np_max_diff(
        {n: p.float().cpu().numpy() for n, p in opt.params.items()}, saved)
    if start_diff != 0.0:
        fail(f"async LM resume starts {start_diff} from the saved params")
    opt, err, counts = cli_in_process(
        argv + ["--steps", str(ASYNC_LM_STEPS + 2), "--resume", ck],
        "async LM resumed to update 12, launch counts")
    g = opt.grads_computed
    if len(opt.timings) != 2 or int(next(iter(
            opt.state.values()))["step"]) != ASYNC_LM_STEPS + 2:
        fail(f"async LM resume ran {len(opt.timings)} updates")
    check_params_finite(opt, "async LM resume")
    expect_counts("async LM resume", counts, flash_fwd=4 * g,
                  flash_bwd_dkdv=4 * g, flash_bwd_dq=4 * g,
                  block_quantize=len(opt.params) * g, block_dequant_sum=2)
    print(f"[async] LM resume: starts from the saved params (max diff "
          f"{start_diff}); 2 updates, {g} gradients computed, launches "
          f"{counts} (4 of each flash kernel a gradient)")
    del opt
    torch.cuda.empty_cache()


def async_card_vs_cpu():
    """Run 5: a lockstep single worker (sequential SGD through the async
    pipeline) on the small MLP, 6 identity, 2 bf16 and 2 blockq updates,
    on the card (kernels) and on the CPU (plain versions): params within
    rtol 1e-4 / atol 1e-5, at most one element in 10,000 outside (a bf16
    or blockq code one quantum apart), as phase 5 holds the sync MLP.  The
    bf16 run weights its fills by staleness, so the bf16 wire is scaled
    (`Codec.scale_codes`) before its ``cast_sum``."""
    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch import AsyncSGD
    from pytorch_ps_mpi_tpu_torch.async_ps import dataset_batch_fn
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_mnist
    from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn

    named = init_mlp(np.random.RandomState(0), (784, 64, 10))
    x, y = synthetic_mnist(256, seed=1)
    for code, updates in (("identity", 6), ("bf16", 2), ("blockq", 2)):
        out = {}
        for device in ("cuda", "cpu"):
            opt = AsyncSGD(list(named.items()), lr=0.05, momentum=0.9,
                           quota=1, code=code,
                           staleness_weighting=code == "bf16",
                           devices=[torch.device(device)])
            opt._lockstep = True
            opt.compile_step(mlp_loss_fn)
            reset_launch_counts()
            hist = opt.run(dataset_batch_fn(x, y, 64, seed=2), steps=updates)
            counts = launch_counts()
            out[device] = (hist["losses"], {n: p.cpu().numpy()
                                            for n, p in opt.params.items()})
            if device == "cuda":
                _expect_async_counts(f"async MLP {code} on the card", hist,
                                     counts, code, len(named), updates)
        a, b = out["cuda"][1], out["cpu"][1]
        outside = sum(int((~np.isclose(a[n], b[n], rtol=1e-4,
                                       atol=1e-5)).sum()) for n in b)
        total = sum(v.size for v in b.values())
        print(f"[async] lockstep MLP {code}, {updates} updates, card vs CPU: "
              f"losses {out['cuda'][0]} vs {out['cpu'][0]}, max difference "
              f"{_np_max_diff(a, b)}, {outside} of {total} elements outside "
              f"rtol 1e-4 / atol 1e-5")
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
        if outside > (0 if code == "identity" else 1e-4 * total):
            fail(f"async MLP {code} card vs CPU: {outside} elements apart")


def run_async_phase():
    """Phase 6: the in-process async PS on the card (runs 1-5)."""
    import shutil
    import tempfile

    import torch

    from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    named, loss_fn, batch_fn = _async_resnet18()
    leaves = len(named)
    # Run 1: one worker sharing the card with the PS, quota 1.  The bf16
    # run weights each fill by its staleness, so the weights scale the
    # bf16 wire (`Codec.scale_codes`) before the grouped ``cast_sum``.
    ips1 = {}
    for code in ("identity", "bf16", "blockq"):
        opt, hist, counts, ips1[code] = async_run(
            f"ResNet-18 {code}, quota 1 (run 1)", named, loss_fn, batch_fn,
            updates=ASYNC_TIMED, warm=ASYNC_WARM, lr=ASYNC_LR, quota=1,
            code=code, staleness_weighting=code == "bf16")
        _expect_async_counts(f"run 1 {code}", hist, counts, code, leaves,
                             ASYNC_TIMED)
        del opt
    # Run 2: a PS and four worker threads on the one card.
    devices = [torch.device("cuda", 0)] * (ASYNC_WORKERS + 1)
    opt, hist, counts, ips2 = async_run(
        f"ResNet-18 blockq, {ASYNC_WORKERS} workers on one card (run 2)",
        named, loss_fn, batch_fn, updates=ASYNC_TIMED, warm=ASYNC_WARM,
        devices=devices, lr=ASYNC_LR / ASYNC_QUOTA, quota=ASYNC_QUOTA,
        code="blockq")
    _expect_async_counts("run 2", hist, counts, "blockq", leaves,
                         ASYNC_TIMED)
    print(f"[async] run 2 against run 1 (blockq): {ips2:.1f} against "
          f"{ips1['blockq']:.1f} images/s, ratio "
          f"{ips2 / ips1['blockq']:.3f}")
    profile_async(opt, batch_fn, "run 2")
    del opt
    # Run 3: robust fills against a sign-flipping worker.
    plan = FaultPlan(byzantine_rank=0, byzantine_mode="sign_flip")
    for aggregate, kw in (("trimmed_mean", dict(trim_k=1)), ("median", {}),
                          ("norm_clip", {})):
        opt, hist, counts, _ = async_run(
            f"ResNet-18 blockq, {aggregate} against a sign-flipping rank 0 "
            f"(run 3)", named, loss_fn, batch_fn,
            updates=ASYNC_ROBUST_UPDATES, devices=devices,
            lr=ASYNC_LR / ASYNC_QUOTA, quota=ASYNC_QUOTA, code="blockq",
            aggregate=aggregate, fault_plan=plan, **kw)
        # The robust path decodes each contribution on its own: a fill's
        # quota of grouped launches.
        _expect_async_counts(f"run 3 {aggregate}", hist, counts, "blockq",
                             leaves, ASYNC_QUOTA * ASYNC_ROBUST_UPDATES)
        print(f"[async] run 3 {aggregate}: robust_clipped "
              f"{hist['fault_stats']['robust_clipped']}, "
              f"block_dequant_sum a fill "
              f"{counts['block_dequant_sum'] / ASYNC_ROBUST_UPDATES:.0f}")
        del opt
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ps_async_")
    try:
        async_cli_lm(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    async_card_vs_cpu()
    print(f"[async] phase 6 took {time.perf_counter() - t0:.1f} s")
    return {"1 worker": ips1["blockq"], f"{ASYNC_WORKERS} workers": ips2}


# ---------------------------------------------------------------------------
# Phase 7: the multihost async PS on the card
# ---------------------------------------------------------------------------

# Every worker process and every serve() of the phase ends within this.
MH_TIMEOUT = 300
# Run 2: the CLI's LM killed before update 5, checkpointed every 2.
MH_LM_STEPS, MH_LM_KILL_AT, MH_LM_CKPT_EVERY = 10, 5, 2
_MH_LINE = re.compile(r"^MH_WORKER (.*)$", re.M)
# A CLI worker process of run 2 (and of phase 11c, a shard router): the
# CLI's entry point with the launch counts zeroed just before, then one
# MH_WORKER line with the counts and the gradients it computed.
_MH_CLI_WORKER_BOOT = (
    "import json, sys, torch\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "from pytorch_ps_mpi_tpu_torch import train\n"
    "from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck\n"
    "from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa\n"
    "ck.reset_launch_counts()\n"
    "fa.reset_launch_counts()\n"
    "w = train.main(sys.argv[1:])\n"
    "torch.cuda.synchronize()\n"
    "plan = getattr(w, '_bucket_plan', None)\n"
    "fs = (w.fault_snapshot() if hasattr(w, 'fault_snapshot')\n"
    "      else w.fault_stats)\n"
    "print('MH_WORKER ' + json.dumps({'rank': w.rank, 'computed': "
    "w.grads_computed, 'counts': {**ck.LAUNCHES, **fa.LAUNCHES}, "
    "'fs': fs, 'n_buckets': "
    "1 if plan is None else plan.n_buckets}), flush=True)\n")


def mh_worker_main(spec_json: str) -> int:
    """A worker process of run 1 (``chip_smoke.py --mh-worker SPEC``):
    run 1's ResNet-18 loss and batches (phase 10a's bench LM where
    ``spec["model"]`` is ``"bench_lm"``), an `AsyncPSWorker` on the card
    connected to the PS at ``spec["port"]`` (phase 11: a `ShardRouter`
    over the fleet at ``spec["ports"]``), trained until DONE with the
    launch counts zeroed just before; then one ``MH_WORKER {json}`` line
    on stdout.  Without a card it raises (no fall back to the CPU)."""
    import torch

    from pytorch_ps_mpi_tpu_torch.multihost_async import AsyncPSWorker
    from pytorch_ps_mpi_tpu_torch.shard import ShardRouter
    from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

    spec = json.loads(spec_json)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if spec.get("model") == "bench_lm":
        _model, _named, loss_fn, batch_fn = _bench_lm_worker(init=False)
    else:
        _named, loss_fn, batch_fn = _async_resnet18()
    if "ports" in spec:
        worker = ShardRouter([("127.0.0.1", p) for p in spec["ports"]],
                             code=spec["code"], device="cuda",
                             io_timeout=MH_TIMEOUT,
                             reconnect_retries=spec["retries"],
                             backoff_base=0.05, backoff_max=0.5)
    else:
        # Phase 12b's workers (``retries``) redial their restarted
        # aggregator on their local ranks.
        ladder = (dict(reconnect_retries=spec["retries"], backoff_base=0.05,
                       backoff_max=0.5) if "retries" in spec
                  else dict(reconnect_retries=2))
        worker = AsyncPSWorker("127.0.0.1", spec["port"],
                               code=spec["code"], device="cuda",
                               io_timeout=MH_TIMEOUT,
                               bucket_bytes=spec.get("bucket_bytes"),
                               fused_encode=spec.get("fused", False),
                               **ladder)
    reset_launch_counts()
    pushed = worker.run(loss_fn, batch_fn)
    torch.cuda.synchronize()
    plan = getattr(worker, "_bucket_plan", None)
    fs = (worker.fault_snapshot() if hasattr(worker, "fault_snapshot")
          else worker.fault_stats)
    print("MH_WORKER " + json.dumps({
        "rank": worker.rank, "pushed": pushed,
        "computed": worker.grads_computed, "counts": launch_counts(),
        "fault_stats": format_fault_stats(fs), "fs": fs,
        "reconnects": worker.reconnects,
        "plan": None if plan is None else plan.describe()}), flush=True)
    return 0


def _mh_spawn(argv, log):
    """A process of the phase: stdout piped (drained by `_mh_finish`),
    stderr to ``log``."""
    err = open(log, "w")
    proc = subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                            stderr=err, text=True)
    return proc, err


def _mh_finish(proc, err, what, expect=0):
    """Wait for a process of the phase (killed past `MH_TIMEOUT`); fails
    unless it exits with ``expect`` (None: any nonzero code).  Returns
    (stdout, stderr)."""
    try:
        out, _ = proc.communicate(timeout=MH_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    err.close()
    with open(err.name) as f:
        text = f.read()
    ok = (proc.returncode != 0 if expect is None
          else proc.returncode == expect)
    if not ok:
        print(text[-6000:], file=sys.stderr)
        fail(f"{what}: exited {proc.returncode}, expected "
             f"{'nonzero' if expect is None else expect}")
    return out, text


def _mh_worker_result(out, what) -> dict:
    m = _MH_LINE.search(out)
    if m is None:
        fail(f"{what}: no MH_WORKER line")
    return json.loads(m.group(1))


def _mh_first_line(proc, err, pattern, what):
    """The match of ``pattern`` on the process's first stdout line (read
    within `MH_TIMEOUT`); a process that prints none is killed and fails
    the phase."""
    import select

    line, end = "", time.monotonic() + MH_TIMEOUT
    while not line.endswith("\n") and time.monotonic() < end:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line += proc.stdout.readline()
        elif proc.poll() is not None:
            break
    m = re.match(pattern, line.strip())
    if m is None:
        proc.kill()
        proc.communicate()
        err.close()
        with open(err.name) as f:
            print(f.read()[-6000:], file=sys.stderr)
        fail(f"{what}: no first line {pattern!r} ({line.strip()!r})")
    return m


def _mh_port(proc, err, what) -> int:
    """The server's port from its first stdout line."""
    return int(_mh_first_line(proc, err, r"serving on port (\d+)$",
                              what).group(1))


class _UtilSampler:
    """nvidia-smi's utilization of the card, sampled every 100 ms by a
    background ``nvidia-smi -lms 100`` into a file (its figure is the
    share of sample periods in which a kernel ran, not the profiler's
    busy share)."""

    def __init__(self, path):
        self.path = path
        self.proc = None

    def start(self):
        self.out = open(self.path, "w")
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "--id=0", "-lms", "100"],
            stdout=self.out, stderr=subprocess.DEVNULL)

    def stop(self) -> "list[int]":
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        with open(self.path) as f:
            return [int(v) for v in f.read().split() if v.isdigit()]


def _serve_thread(srv, steps, **kw):
    """``srv.serve(steps)`` on a thread of this process: (thread, box)."""
    import threading

    box = {}

    def run():
        try:
            box["hist"] = srv.serve(steps=steps, idle_timeout=MH_TIMEOUT,
                                    **kw)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the caller
            box["error"] = exc

    t = threading.Thread(target=run, name="mh-serve")
    t.start()
    return t, box


def _mh_joined(t, box, what) -> dict:
    t.join(MH_TIMEOUT + 60)
    if t.is_alive():
        fail(f"{what}: serve() did not end")
    if "error" in box:
        raise box["error"]
    return box["hist"]


def mh_resnet_run(what, named, loss_fn, tmp, *, workers, quota, lr,
                  threads_ips, bucket_bytes=None, fused=False, out=None):
    """Run 1: an `AsyncSGDServer` (ResNet-18, blockq, momentum 0.9) in
    this process on the card, ``workers`` worker processes on the same
    card over loopback; 4 warm-up and 40 timed updates.  The launch
    counts are read around the serve here (the PS's) and in each worker
    (its own).  ``bucket_bytes`` streams each gradient in buckets
    (phase 8; ``fused``: encoded inside backward), with the stream's
    counters asserted.  Returns images/s over the timed window; ``out``
    (a dict) also takes the GRAD bytes a timed update (phase 12 reads
    run 1b's)."""
    import os

    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch.multihost_async import AsyncSGDServer
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

    updates = ASYNC_WARM + ASYNC_TIMED
    srv = AsyncSGDServer(list(named.items()), lr=lr, momentum=0.9,
                         quota=quota, code="blockq", device="cuda")
    srv.compile_step(loss_fn)
    port = srv.address[1]
    tag = f"run1-{workers}"
    if bucket_bytes is not None:
        tag += f"-b{bucket_bytes}{'f' if fused else ''}"
    spec = {"port": port, "code": "blockq", "bucket_bytes": bucket_bytes,
            "fused": fused}
    procs = [_mh_spawn([os.path.abspath(__file__), "--mh-worker",
                        json.dumps(spec)],
                       os.path.join(tmp, f"{tag}-worker{i}.err"))
             for i in range(workers)]
    sampler = _UtilSampler(os.path.join(tmp, f"{tag}-util.txt"))
    torch.cuda.synchronize()
    reset_launch_counts()
    t, box = _serve_thread(srv, updates, warmup_steps=ASYNC_WARM)
    while t.is_alive() and srv._served_version < ASYNC_WARM:
        time.sleep(0.005)
    sampler.start()
    t.join(MH_TIMEOUT + 60)
    util = sampler.stop()
    counts = launch_counts()
    try:
        hist = _mh_joined(t, box, what)
    finally:
        # The workers end at their next pull (DONE).  The PS closes once
        # they have, so every frame they sent is decoded (and a bucket
        # stream assembled) before its decode pool shuts down.
        try:
            results = [_mh_worker_result(_mh_finish(p, e, what)[0], what)
                       for p, e in procs]
        finally:
            srv.close()
    # The PS: one grouped decode a fill, nothing else.
    expect_counts(f"{what}, the PS", counts,
                  block_dequant_sum=updates * ck.group_launches(
                      "block_dequant_sum", len(named)))
    for r in results:
        expect_counts(f"{what}, worker rank {r['rank']}", r["counts"],
                      block_quantize=len(named) * r["computed"])
    if bucket_bytes is not None:
        check_bucket_stream(what, srv, results, fused)
    check_params_finite(srv, what)
    losses = hist["losses"][ASYNC_WARM:]
    first, last = _fifths(losses)
    if not all(math.isfinite(v) for v in losses) or not last < first:
        fail(f"{what}: losses {hist['losses']}")
    contrib = hist["contributors"][ASYNC_WARM:]
    grads = sum(len(c) for c in contrib)
    ips = grads * ASYNC_BATCH / hist["steady_wall_time"]
    stale = hist["staleness"][ASYNC_WARM:]
    timed = srv.timings[ASYNC_WARM:]
    per = {k: 1e3 * sum(d[k] for d in timed) / len(timed)
           for k in ("comm_wait", "optim_step_time", "isend_time")}
    fs = hist["fault_stats"]
    full_parms = fs["parm_encodes"] + fs["parm_fanout_reuse"]
    parm_frame = fs["parm_bytes_wire"] / max(1, fs["parm_encodes"])
    grad_bytes = float(np.mean([d["msg_bytes"] for d in timed]))
    print(f"[mh] {what}: {ASYNC_TIMED} timed updates, {grads} grads "
          f"({sum(r['computed'] for r in results)} computed by the workers "
          f"over the whole run), {ips:.1f} images/s, loss first/last fifth "
          f"{first:.4f} / {last:.4f}, staleness mean "
          f"{sum(stale) / len(stale):.3f} max {max(stale):.3f}; the PS a "
          f"timed update (ms): comm_wait {per['comm_wait']:.3f}, "
          f"optim_step_time {per['optim_step_time']:.3f}, isend_time "
          f"{per['isend_time']:.3f}")
    print(f"[mh] {what}: wire a update over all {updates}: PARM "
          f"{full_parms * parm_frame / updates / 1e6:.3f} MB "
          f"({full_parms} full PARM frames of {parm_frame / 1e6:.3f} MB, "
          f"{fs['parm_unchanged']} unchanged), GRAD "
          f"{grad_bytes * grads / len(contrib) / 1e6:.3f} MB "
          f"({grads / len(contrib):.2f} a fill of {grad_bytes / 1e6:.3f} "
          f"MB); PS launches {counts}; worker launches "
          f"{[(r['rank'], r['computed'], r['counts']['block_quantize']) for r in results]}"
          f" (rank, gradients, block_quantize)")
    if util:
        print(f"[mh] {what}: nvidia-smi utilization.gpu over the timed "
              f"window (its own figure, not the profiler's busy share): "
              f"mean {sum(util) / len(util):.1f} %, {len(util)} samples "
              f"at 100 ms, min {min(util)} max {max(util)}")
    else:
        print(f"[mh] {what}: nvidia-smi utilization: not measured")
    print(f"[mh] {what}: fault stats {format_fault_stats(fs)}; workers "
          f"{[r['fault_stats'] for r in results]}")
    print(f"[mh] {what}: worker processes {ips:.1f} images/s against "
          f"phase 6's worker threads {threads_ips:.1f} (ratio "
          f"{ips / threads_ips:.3f})")
    if out is not None:
        out["grad_bytes"] = grad_bytes * grads / len(contrib)
    return ips


def check_bucket_stream(what, srv, results, fused):
    """The bucket stream's counters once every worker has exited: each
    worker sent its plan's buckets for every gradient it computed (one
    fused encode a gradient when ``fused``), the PS assembled every bucket
    sent, and no assembly was left partial."""
    for t in list(srv._conn_threads):
        t.join(MH_TIMEOUT)
    sent = 0
    for r in results:
        fs, plan, g = r["fs"], r["plan"], r["computed"]
        if plan is None or plan["n_buckets"] < 2:
            fail(f"{what}, worker rank {r['rank']}: no bucket plan {plan}")
        if fs["buckets_sent"] != plan["n_buckets"] * g:
            fail(f"{what}, worker rank {r['rank']}: {fs['buckets_sent']} "
                 f"buckets sent for {g} gradients of {plan['n_buckets']}")
        if fs["fused_encodes"] != (g if fused else 0):
            fail(f"{what}, worker rank {r['rank']}: fused_encodes "
                 f"{fs['fused_encodes']} for {g} gradients")
        sent += fs["buckets_sent"]
    filled = srv.fault_stats["buckets_filled"]
    partial = srv.fault_stats["bucket_partial_timeouts"]
    if filled != sent or partial:
        fail(f"{what}: the PS filled {filled} of {sent} buckets sent, "
             f"{partial} partial")
    plan = results[0]["plan"]
    print(f"[mh] {what}: bucket plan {plan['n_buckets']} buckets of "
          f"{plan['bucket_bytes']} bytes (leaves a bucket "
          f"{plan['bucket_sizes']}), {sent} buckets sent and filled, "
          f"{partial} partial, fused encodes "
          f"{[r['fs']['fused_encodes'] for r in results]}")


def mh_cli_lm(tmp):
    """Run 2: ``ps-torch-train --serve 0`` and two ``--connect`` worker
    processes with the CLI's LM (bf16, flash, blockq, batch 16 x 1024;
    the server's parameter wire in bf16), quota 2, for 10 updates; the
    server is killed before update 5 (``--chaos kill_ps_at``), having
    checkpointed every 2, and relaunched on its port with ``--resume``;
    the workers reconnect and the run completes all 10 updates with
    continuous versions.  Each worker's launch counts: 4 of each flash
    kernel and a ``block_quantize`` a leaf per gradient."""
    import os

    from pytorch_ps_mpi_tpu_torch import train
    from pytorch_ps_mpi_tpu_torch.native import serializer

    ck = os.path.join(tmp, "mh_lm.psz")
    common = CLI_LM + ["--codec", "blockq", "--quota", "2"]
    server = ["-c", _CLI_BOOT, "default", *common, "--steps",
              str(MH_LM_STEPS), "--save", ck, "--checkpoint-every",
              str(MH_LM_CKPT_EVERY), "--wire-codec", "bf16"]
    t0 = time.perf_counter()
    srv1, e1 = _mh_spawn(server + ["--serve", "0", "--chaos",
                                   json.dumps({"kill_ps_at": MH_LM_KILL_AT})],
                         os.path.join(tmp, "run2-server1.err"))
    port = _mh_port(srv1, e1, "LM CLI server")
    workers = [_mh_spawn(["-c", _MH_CLI_WORKER_BOOT, *common, "--connect",
                          f"127.0.0.1:{port}"],
                         os.path.join(tmp, f"run2-worker{i}.err"))
               for i in range(2)]
    _, err1 = _mh_finish(srv1, e1, "LM CLI server (killed)", expect=None)
    if f"FaultPlan: PS killed before update {MH_LM_KILL_AT}" not in err1:
        fail("LM CLI server: not killed by the fault plan")
    t_kill = time.perf_counter()
    srv2, e2 = _mh_spawn(server + ["--serve", str(port), "--resume", ck],
                         os.path.join(tmp, "run2-server2.err"))
    if _mh_port(srv2, e2, "LM CLI server (resumed)") != port:
        fail("LM CLI server relaunched on another port")
    results = []
    for i, (p, e) in enumerate(workers):
        out, err = _mh_finish(p, e, f"LM CLI worker {i}")
        results.append((_mh_worker_result(out, f"LM CLI worker {i}"), err))
    _, err2 = _mh_finish(srv2, e2, "LM CLI server (resumed)")
    wall = time.perf_counter() - t0
    start = MH_LM_KILL_AT - MH_LM_KILL_AT % MH_LM_CKPT_EVERY
    if f"resumed from {ck} at step {start}" not in err2:
        fail(f"LM CLI server: not resumed at step {start}")
    m = re.search(r"^done: (\d+) updates, (\d+) grads, ([\d.]+) images/sec,"
                  r" mean staleness ([\d.]+)$", err2, re.M)
    if m is None or int(m.group(1)) != MH_LM_STEPS - start:
        fail("LM CLI server: no 'done:' line for the resumed updates")
    with open(ck, "rb") as f:
        _, meta = serializer.loads(f.read(), with_meta=True)
    if (meta["step"], meta["extra"]["served_version"]) != (MH_LM_STEPS,) * 2:
        fail(f"LM CLI: final checkpoint at step {meta['step']}, version "
             f"{meta['extra']['served_version']}")
    args = train.make_parser().parse_args(CLI_LM)
    n_leaves = len(train._build_lm_async(args)[0])
    for r, err in results:
        g = r["computed"]
        expect_counts(f"LM CLI worker rank {r['rank']}", r["counts"],
                      flash_fwd=4 * g, flash_bwd_dkdv=4 * g,
                      flash_bwd_dq=4 * g, block_quantize=n_leaves * g)
        if f"worker rank {r['rank']} done:" not in err \
                or "reconnect(s) to the PS" not in err:
            fail(f"LM CLI worker rank {r['rank']}: no reconnect or no "
                 f"'done:' line")
    rows_s = float(m.group(3))
    print(f"[mh] LM CLI (run 2): killed before update {MH_LM_KILL_AT}, "
          f"resumed at {start} on port {port} "
          f"{time.perf_counter() - t_kill:.1f} s after the kill; the "
          f"resumed server's done line: {m.group(1)} updates, "
          f"{m.group(2)} grads, {rows_s:.1f} rows/s ({rows_s * 1024:.0f} "
          f"tokens/s), mean staleness {m.group(4)}; final checkpoint at "
          f"step {meta['step']}, served version "
          f"{meta['extra']['served_version']}; workers (rank, gradients, "
          f"launches) {[(r['rank'], r['computed'], r['counts']) for r, _ in results]}"
          f" (4 of each flash kernel and {n_leaves} block_quantize a "
          f"gradient); {wall:.1f} s in all")


def mh_card_vs_cpu(bucket_bytes=None):
    """Run 3: a PS on the card and one lockstep worker on the card
    (quota 1, one gradient at a time: sequential SGD through the wire),
    the small MLP, 6 identity and 2 blockq updates, against the same
    conversation with ``device="cpu"`` everywhere: params within phase 6
    run 5's rtol 1e-4 / atol 1e-5, at most one element in 10,000 outside
    (a blockq code one quantum apart).  ``bucket_bytes`` (phase 8) streams
    each gradient in fused-encoded buckets, at least 2."""
    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch.async_ps import dataset_batch_fn
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_mnist
    from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
    from pytorch_ps_mpi_tpu_torch.multihost_async import (AsyncPSWorker,
                                                          AsyncSGDServer)

    named = init_mlp(np.random.RandomState(0), (784, 64, 10))
    x, y = synthetic_mnist(256, seed=1)
    for code, updates in (("identity", 6), ("blockq", 2)):
        out = {}
        for device in ("cuda", "cpu"):
            srv = AsyncSGDServer(list(named.items()), lr=0.05, momentum=0.9,
                                 quota=1, code=code, device=device)
            srv.compile_step(mlp_loss_fn)
            torch.cuda.synchronize()
            reset_launch_counts()
            t, box = _serve_thread(srv, updates)
            try:
                worker = AsyncPSWorker(
                    "127.0.0.1", srv.address[1], code=code, device=device,
                    reconnect_retries=1, bucket_bytes=bucket_bytes,
                    fused_encode=bucket_bytes is not None)
                worker._lockstep = True
                worker.run(mlp_loss_fn, dataset_batch_fn(x, y, 64, seed=2))
                hist = _mh_joined(t, box, f"lockstep MLP {code} {device}")
            finally:
                srv.close()
            if bucket_bytes is not None:
                n = worker._bucket_plan.n_buckets
                if n < 2 or hist["fault_stats"]["buckets_filled"] != \
                        n * updates:
                    fail(f"lockstep MLP {code} {device}: {n} buckets, "
                         f"{hist['fault_stats']['buckets_filled']} filled")
            torch.cuda.synchronize()
            counts = launch_counts()
            out[device] = (hist["losses"], {n: p.cpu().numpy()
                                            for n, p in srv.params.items()})
            if device == "cuda" and code == "blockq":
                expect_counts(f"lockstep MLP {code} on the card", counts,
                              block_quantize=len(named) * updates,
                              block_dequant_sum=updates)
        a, b = out["cuda"][1], out["cpu"][1]
        outside = sum(int((~np.isclose(a[n], b[n], rtol=1e-4,
                                       atol=1e-5)).sum()) for n in b)
        total = sum(v.size for v in b.values())
        tag = ("run 3" if bucket_bytes is None else
               f"phase 8, {worker._bucket_plan.n_buckets} fused buckets "
               f"of {bucket_bytes} bytes")
        print(f"[mh] lockstep MLP {code} ({tag}), {updates} updates through "
              f"the wire, card vs CPU: losses {out['cuda'][0]} vs "
              f"{out['cpu'][0]}, max difference {_np_max_diff(a, b)}, "
              f"{outside} of {total} elements outside rtol 1e-4 / atol "
              f"1e-5")
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
        if outside > (0 if code == "identity" else 1e-4 * total):
            fail(f"lockstep MLP {code} card vs CPU: {outside} elements "
                 f"apart")


def run_multihost_phase(threads_ips):
    """Phase 7: the multihost async PS over loopback TCP, worker processes
    on the one card (runs 1-3).  Returns run 1a's images/s and run 1b's
    (images/s, GRAD bytes a timed update)."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ps_mh_")
    try:
        named, loss_fn, _ = _async_resnet18()
        run1a = mh_resnet_run(
            "ResNet-18 blockq, 1 worker process, quota 1 (run 1a)", named,
            loss_fn, tmp, workers=1, quota=1, lr=ASYNC_LR,
            threads_ips=threads_ips["1 worker"])
        run1b_out: dict = {}
        run1b = mh_resnet_run(
            f"ResNet-18 blockq, {ASYNC_WORKERS} worker processes, quota "
            f"{ASYNC_QUOTA} (run 1b)", named, loss_fn, tmp,
            workers=ASYNC_WORKERS, quota=ASYNC_QUOTA,
            lr=ASYNC_LR / ASYNC_QUOTA,
            threads_ips=threads_ips[f"{ASYNC_WORKERS} workers"],
            out=run1b_out)
        del named, loss_fn
        torch.cuda.empty_cache()
        mh_cli_lm(tmp)
        mh_card_vs_cpu()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[mh] phase 7 took {time.perf_counter() - t0:.1f} s")
    return run1a, (run1b, run1b_out["grad_bytes"])


# ---------------------------------------------------------------------------
# Phase 8: the bucket-streamed gradient (the v11 GRAD stream)
# ---------------------------------------------------------------------------

# Run 1a's cell with each gradient streamed in 4 MiB buckets.
MH_BUCKET_BYTES = 4 << 20
# The lockstep MLP's buckets (its first kernel alone is 200,704 bytes).
MH_MLP_BUCKET_BYTES = 64 << 10


def run_bucket_phase(run1a_ips):
    """Phase 8: run 1a's cell (ResNet-18 blockq, batch 512, one worker
    process, quota 1, 4 warm-up and 40 timed updates) with each gradient
    streamed in 4 MiB buckets, encoded inside backward (8a) and after it
    (8b), beside run 1a's images/s from this call; then run 3's lockstep
    MLP through the wire in fused buckets, card against CPU."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ps_bucket_")
    try:
        named, loss_fn, _ = _async_resnet18()
        for tag, fused in (("8a", True), ("8b", False)):
            ips = mh_resnet_run(
                f"ResNet-18 blockq, 1 worker process, quota 1, "
                f"{MH_BUCKET_BYTES >> 20} MiB buckets, "
                f"{'fused' if fused else 'unfused'} encode (run {tag})",
                named, loss_fn, tmp, workers=1, quota=1, lr=ASYNC_LR,
                threads_ips=run1a_ips, bucket_bytes=MH_BUCKET_BYTES,
                fused=fused)
            print(f"[bucket] run {tag}: {ips:.1f} images/s against run "
                  f"1a's whole-tree {run1a_ips:.1f} in this call (ratio "
                  f"{ips / run1a_ips:.3f})")
        del named, loss_fn
        torch.cuda.empty_cache()
        mh_card_vs_cpu(MH_MLP_BUCKET_BYTES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[bucket] phase 8 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 9: the dense MoE LM
# ---------------------------------------------------------------------------

# The CLI's LM with a dense MoE MLP of 8 experts (capacity factor 1.25).
MOE = ["--moe-experts", "8"]
MOE_STEPS = 10
MOE_BUCKET_BYTES = 1 << 20


def _moe_leaves() -> int:
    from pytorch_ps_mpi_tpu_torch import train

    args = train.make_parser().parse_args(CLI_LM + MOE)
    return len(train._build_lm_async(args)[0])


def moe_sync(n_leaves):
    """9a: the sync CLI, blockq, 10 steps, in this process with the launch
    counts read around it: 4 of each flash kernel and a ``block_quantize``
    a leaf (the expert leaves among them) a step, one grouped decode a
    step."""
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    opt, err, counts = cli_in_process(
        CLI_LM + MOE + ["--codec", "blockq", "--steps", str(MOE_STEPS)],
        "MoE LM sync (9a)")
    steps, tok_s = _done(err, "MoE LM sync")
    losses = _losses(err, "MoE LM sync")
    if len(opt.params) != n_leaves or not any(
            ".moe.w1" in n for n in opt.params):
        fail(f"MoE LM sync: {len(opt.params)} leaves")
    expect_counts("MoE LM sync", counts, flash_fwd=4 * steps,
                  flash_bwd_dkdv=4 * steps, flash_bwd_dq=4 * steps,
                  block_quantize=n_leaves * steps,
                  block_dequant_sum=steps * ck.group_launches(
                      "block_dequant_sum", n_leaves))
    check_params_finite(opt, "MoE LM sync")
    print(f"[moe] 9a sync CLI, blockq, {steps} steps: {tok_s:.0f} tokens/s "
          f"(done line, first step included); losses {losses}; steady "
          f"step {_steady_ms(opt):.3f} ms; launches {counts}")
    del opt


def moe_async_threads(n_leaves):
    """9b: the in-process async PS on the CLI's MoE LM: a PS and 2 worker
    threads on the card, quota 2, blockq, 10 updates (the CLI's
    ``--async-ps`` takes one worker a visible card, so on one card the
    run uses `AsyncSGD` with the CLI's model and loss)."""
    import torch

    from pytorch_ps_mpi_tpu_torch import AsyncSGD, train
    from pytorch_ps_mpi_tpu_torch.async_ps import lm_batch_fn
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    args = train.make_parser().parse_args(CLI_LM + MOE)
    params, loss_fn, toks = train._build_lm_async(args)
    opt = AsyncSGD(list(params.items()), lr=0.01, momentum=0.9, quota=2,
                   code="blockq", devices=[torch.device("cuda")] * 3)
    opt.compile_step(loss_fn)
    batch_fn = lm_batch_fn(toks, args.batch_size, seed=0)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    hist = opt.run(batch_fn, steps=MOE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    g = hist["grads_computed"]
    expect_counts("MoE LM async", counts, flash_fwd=4 * g,
                  flash_bwd_dkdv=4 * g, flash_bwd_dq=4 * g,
                  block_quantize=n_leaves * g,
                  block_dequant_sum=MOE_STEPS * ck.group_launches(
                      "block_dequant_sum", n_leaves))
    check_params_finite(opt, "MoE LM async")
    if not all(math.isfinite(v) for v in hist["losses"]):
        fail(f"MoE LM async: losses {hist['losses']}")
    tok_s = hist["grads_consumed"] * args.batch_size * args.seq_len / wall
    print(f"[moe] 9b async PS, 2 worker threads, quota 2, blockq, "
          f"{MOE_STEPS} updates: {hist['grads_consumed']} grads ({g} "
          f"computed), {tok_s:.0f} tokens/s (first update included), "
          f"losses {[round(v, 4) for v in hist['losses']]}, staleness mean "
          f"{sum(hist['staleness']) / len(hist['staleness']):.3f}; "
          f"launches {counts}")
    del opt
    torch.cuda.empty_cache()


def moe_multihost(tmp, n_leaves):
    """9c: ``--serve 0`` and two ``--connect`` worker processes with the
    MoE LM, quota 2, 10 updates, each worker streaming its gradients in 1
    MiB buckets encoded inside backward (``--async-bucket-bytes 1048576
    --fused-encode``): in each worker 4 of each flash kernel and a
    ``block_quantize`` a leaf per gradient computed, one fused encode a
    gradient, its plan's buckets for every gradient pushed (the last one
    computed may be cut off mid-stream when the server's process exits);
    the PS's buckets filled."""
    import os

    common = CLI_LM + MOE + ["--codec", "blockq", "--quota", "2"]
    t0 = time.perf_counter()
    srv, e = _mh_spawn(["-c", _CLI_BOOT, "default", *common, "--steps",
                        str(MOE_STEPS), "--serve", "0"],
                       os.path.join(tmp, "moe-server.err"))
    port = _mh_port(srv, e, "MoE LM server")
    # --reconnect-retries 2: a push racing the server's exit redials, and
    # the CLI's default ladder (30 attempts, up to 2 s apart) can hold a
    # worker about a minute after the run ends (phase 9 took 82.9-87.3 s
    # in two runs against 22.1-27.2 s in two others).
    workers = [_mh_spawn(["-c", _MH_CLI_WORKER_BOOT, *common,
                          "--async-bucket-bytes", str(MOE_BUCKET_BYTES),
                          "--fused-encode", "--connect",
                          f"127.0.0.1:{port}", "--reconnect-retries", "2"],
                         os.path.join(tmp, f"moe-worker{i}.err"))
               for i in range(2)]
    results = []
    for i, (p, we) in enumerate(workers):
        out, err = _mh_finish(p, we, f"MoE LM worker {i}")
        if "bucket streaming on (fused encode)" not in err:
            fail(f"MoE LM worker {i}: bucket streaming not on")
        r = _mh_worker_result(out, f"MoE LM worker {i}")
        done = re.search(rf"^worker rank {r['rank']} done: (\d+) gradients "
                         rf"pushed$", err, re.M)
        if done is None:
            fail(f"MoE LM worker {i}: no 'done:' line")
        r["pushed"] = int(done.group(1))
        results.append(r)
    _, err = _mh_finish(srv, e, "MoE LM server")
    wall = time.perf_counter() - t0
    m = re.search(r"^done: (\d+) updates, (\d+) grads, ([\d.]+) images/sec,"
                  r" mean staleness ([\d.]+)$", err, re.M)
    if m is None or int(m.group(1)) != MOE_STEPS:
        fail("MoE LM server: no 'done:' line")
    filled = re.search(r"buckets_filled=(\d+)", err)
    consumed = int(m.group(2))
    for r in results:
        g, fs, n = r["computed"], r["fs"], r["n_buckets"]
        expect_counts(f"MoE LM worker rank {r['rank']}", r["counts"],
                      flash_fwd=4 * g, flash_bwd_dkdv=4 * g,
                      flash_bwd_dq=4 * g, block_quantize=n_leaves * g)
        if (n < 2 or not n * r["pushed"] <= fs["buckets_sent"] <= n * g
                or r["pushed"] < g - 1 or fs["fused_encodes"] != g):
            fail(f"MoE LM worker rank {r['rank']}: {n} buckets, "
                 f"{fs['buckets_sent']} sent, {fs['fused_encodes']} fused "
                 f"encodes for {g} gradients, {r['pushed']} pushed")
    n_buckets = results[0]["n_buckets"]
    if (filled is None or int(filled.group(1)) < n_buckets * consumed
            or "bucket_partial_timeouts" in err):
        fail(f"MoE LM server: buckets filled "
             f"{filled and filled.group(1)} for {consumed} gradients of "
             f"{n_buckets} buckets")
    rows_s = float(m.group(3))
    print(f"[moe] 9c --serve 0 and two --connect workers, {n_buckets} "
          f"fused buckets of {MOE_BUCKET_BYTES} bytes a gradient: "
          f"{m.group(1)} updates, {consumed} grads, {rows_s * 1024:.0f} "
          f"tokens/s ({rows_s:.1f} rows/s on the done line), mean "
          f"staleness {m.group(4)}; the PS filled {filled.group(1)} "
          f"buckets; workers (rank, gradients computed and pushed, "
          f"buckets sent, launches) "
          f"{[(r['rank'], r['computed'], r['pushed'], r['fs']['buckets_sent'], r['counts']) for r in results]}"
          f"; {wall:.1f} s in all")


def run_moe_phase():
    """Phase 9: the CLI's LM with a dense MoE of 8 experts on the sync,
    async and multihost roles (9a-9c)."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ps_moe_")
    try:
        n_leaves = _moe_leaves()
        moe_sync(n_leaves)
        torch.cuda.empty_cache()
        moe_async_threads(n_leaves)
        moe_multihost(tmp, n_leaves)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[moe] phase 9 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 10: the serve tier on a single PS
# ---------------------------------------------------------------------------

# 10a: the bench LM served while it trains.  The PS and one worker process
# (blockq at the bench batch, flash attention) for SERVE_UPDATES updates;
# a reader on the PS feeds the front-end SERVE_REQUESTS requests, one each
# SERVE_SUBMIT_S once training publishes, then drains.
SERVE_UPDATES = 6
SERVE_MAX_BATCH, SERVE_BUF, SERVE_QUEUE = 4, 1024, 16
SERVE_REQUESTS, SERVE_NEW, SERVE_SUBMIT_S = 32, 8, 0.2
SERVE_PROMPT = (8, 512)
# 10b: the CLI.  The readers run the CLI's LM without --attn flash (the
# reader refuses it as inert: its front-end runs dense attention, as the
# JAX CLI's does).
SERVE_CLI_STEPS, SERVE_CLI_REQUESTS, SERVE_CLI_POLLS = 30, 16, 100
# The small LM the front-end runs on the card and on the CPU: f32, so the
# logits differ by f32 rounding and the 1e-4 top-2 margin rule applies.
SERVE_SMALL = dict(vocab_size=512, d_model=256, n_heads=4, n_layers=2,
                   d_ff=512, max_len=256)
SERVE_MARGIN = 1e-4


def _bench_lm_worker(init: bool = True):
    """The bench LM's ``(model, named, loss_fn, batch_fn)`` for an async
    PS: flash attention, batch 16 x 1024 from synthetic tokens, params
    from seed 0 (None when ``init`` is False: a worker pulls them)."""
    import functools

    import torch

    from pytorch_ps_mpi_tpu_torch import flash_attention
    from pytorch_ps_mpi_tpu_torch.async_ps import lm_batch_fn
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_lm
    from pytorch_ps_mpi_tpu_torch.models import (TransformerLM, build_lm,
                                                 make_lm_loss)

    model = TransformerLM(**LM, dtype=torch.bfloat16,
                          attn=functools.partial(flash_attention, causal=True))
    named = build_lm(model, seed=0) if init else None
    toks = synthetic_lm(4 * LM_BATCH, seq_len=LM_SEQ,
                        vocab=LM["vocab_size"], seed=0)
    return model, named, make_lm_loss(model), lm_batch_fn(toks, LM_BATCH)


class _TimedSource:
    """The front-end's ``params_source``: the subscriber, with the wall
    time of each poll that decoded a snapshot (a full one or a delta)."""

    def __init__(self, sub):
        self.sub = sub
        self.read_ms = []

    def poll(self):
        t0 = time.perf_counter()
        out = self.sub.poll()
        if out[2]:
            self.read_ms.append((time.perf_counter() - t0) * 1e3)
        return out


def _same_tree_bits(trees, host) -> bool:
    """Tensors (on the card or the host) against a host tree (numpy, or
    CPU tensors for bf16), bit for bit."""
    import numpy as np
    import torch

    for n, t in trees.items():
        h = host[n]
        if not isinstance(h, torch.Tensor):
            h = torch.from_numpy(np.ascontiguousarray(h))
        if not same_bits(t.detach().cpu(), h):
            return False
    return True


def serve_bench_lm(tmp):
    """10a: an `AsyncSGDServer` on the card holding the bench LM (bf16
    parameter wire, delta snapshots), one `AsyncPSWorker` process pushing
    blockq gradients with flash attention, and in this process a
    `Subscriber(nonblock_heal=True)` feeding an `InferenceFrontend` over
    the same LM with the flash kernel.  The launch counts here are the
    PS's fills and the front-end's decode steps (the worker counts its
    own)."""
    import os

    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_lm
    from pytorch_ps_mpi_tpu_torch.multihost_async import AsyncSGDServer
    from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs
    from pytorch_ps_mpi_tpu_torch.serve import InferenceFrontend, Subscriber
    from pytorch_ps_mpi_tpu_torch.errors import InferShedError
    from pytorch_ps_mpi_tpu_torch.serve.infer import decode_step
    from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

    t_start = time.perf_counter()
    model, named, loss_fn, _ = _bench_lm_worker()
    srv = AsyncSGDServer(list(named.items()), lr=0.01, momentum=0.9,
                         quota=1, code="blockq", device="cuda",
                         wire_codec="bf16", delta_parm=True)
    srv.compile_step(loss_fn)
    reset_launch_counts()
    t, box = _serve_thread(srv, SERVE_UPDATES)
    spec = {"port": srv.address[1], "code": "blockq", "model": "bench_lm"}
    proc, err = _mh_spawn([os.path.abspath(__file__), "--mh-worker",
                           json.dumps(spec)],
                          os.path.join(tmp, "serve-worker.err"))
    sub = Subscriber("127.0.0.1", srv.address[1], nonblock_heal=True,
                     io_timeout=MH_TIMEOUT)
    t0 = time.perf_counter()
    version0, params = sub.snapshot()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    source = _TimedSource(sub)
    fe = InferenceFrontend(model, params, max_batch=SERVE_MAX_BATCH,
                           buf_len=SERVE_BUF, max_queue=SERVE_QUEUE,
                           params_source=source)
    rng = np.random.RandomState(0)
    lengths = rng.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                          size=SERVE_REQUESTS)
    toks = synthetic_lm(SERVE_REQUESTS, seq_len=SERVE_PROMPT[1],
                        vocab=LM["vocab_size"], seed=0)
    # Traffic starts once training has published: the engine polls (and
    # swaps) on every step, idle or not.
    end = time.monotonic() + MH_TIMEOUT
    while srv._served_version < 1 and time.monotonic() < end:
        fe.step()
        time.sleep(0.05)
    if srv._served_version < 1:
        fail("serve 10a: training published no version")
    handles, shed = [], 0
    t_traffic = time.perf_counter()
    next_at = t_traffic
    while len(handles) + shed < SERVE_REQUESTS:
        if time.perf_counter() >= next_at:
            i = len(handles) + shed
            try:
                handles.append(fe.submit(toks[i, :lengths[i]],
                                         max_new=SERVE_NEW))
            except InferShedError:
                shed += 1
            next_at += SERVE_SUBMIT_S
        if fe.step() == 0:
            time.sleep(0.005)
    fe.drain()
    wall = time.perf_counter() - t_traffic
    hist = _mh_joined(t, box, "serve 10a")
    out, werr = _mh_finish(proc, err, "serve 10a worker")
    worker = _mh_worker_result(out, "serve 10a worker")
    counts = launch_counts()
    stats = fe.stats()
    # Every admitted request returned its tokens; the front-end swapped
    # while it decoded, and what the card holds is the reader's tree.
    for h in handles:
        if len(h.result(0)) != SERVE_NEW:
            fail(f"serve 10a: a request returned {len(h.result(0))} tokens")
    if stats["param_swaps"] < 1:
        fail("serve 10a: no hot swap during the traffic")
    if not _same_tree_bits(fe._dev_params, sub.params):
        fail("serve 10a: the card's parameters are not the subscriber's "
             "tree bit for bit")
    ring = srv._delta_ring.get(sub.version)
    ring_bitwise = ring is not None and _same_tree_bits(
        {n: torch.from_numpy(np.asarray(a)) for n, a in ring.items()},
        sub.params)
    if ring is not None and not ring_bitwise:
        fail(f"serve 10a: the subscriber's tree at version {sub.version} "
             f"is not the server's post-decode tree")
    # This process's launches: the front-end's, 12 flash_fwd a decode step
    # (nothing else here runs attention), and the PS's, one
    # block_dequant_sum a fill.
    fills = len(hist["versions"])
    expect_counts("serve 10a (the PS and the front-end)", counts,
                  flash_fwd=LM["n_layers"] * stats["steps"],
                  block_dequant_sum=fills)
    g = worker["computed"]
    expect_counts("serve 10a worker", worker["counts"],
                  flash_fwd=LM["n_layers"] * g,
                  flash_bwd_dkdv=LM["n_layers"] * g,
                  flash_bwd_dq=LM["n_layers"] * g,
                  block_quantize=LM_TENSORS * g)
    fs = hist["fault_stats"]
    # A decode step at the full buffer, CUDA events, and a snapshot's
    # copy to the card (one staged host-to-device copy), outside the
    # counted window.
    module = fe._module()
    tokens = torch.from_numpy(np.asarray(
        synthetic_lm(SERVE_MAX_BATCH, seq_len=SERVE_BUF - 1,
                     vocab=LM["vocab_size"], seed=1))).cuda()
    positions = fe._positions
    full = torch.full((SERVE_MAX_BATCH,), SERVE_BUF, dtype=torch.int32,
                      device="cuda")
    with torch.inference_mode():
        step_ms = time_ms(lambda: decode_step(module, fe._dev_params, tokens,
                                              positions, full), reps=5,
                          warm=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe._to_device(sub.params)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    lat = stats["request_latency"]
    generated = SERVE_NEW * len(handles)
    full_bytes = fs["parm_bytes_wire"] / max(1, fs["parm_encodes"])
    # A delta's bytes (indices and values) between consecutive versions
    # still in the ring, beside a full snapshot's.
    with srv._parm_lock:
        ring = dict(srv._delta_ring)
    delta_bytes = [tcodecs.diff_wire_delta(ring[v - 1], ring[v])[1]
                   for v in sorted(ring) if v - 1 in ring]
    srv.close()
    sub.close()
    print(f"[serve] 10a bench LM served while it trains ({SERVE_UPDATES} "
          f"updates, bf16 parameter wire, delta snapshots): "
          f"{len(handles)} requests of {SERVE_NEW} tokens (prompts "
          f"{lengths.min()}-{lengths.max()} tokens), {shed} shed; p50 "
          f"{lat['p50_s'] * 1e3:.1f} ms, p95 {lat['p95_s'] * 1e3:.1f} ms; "
          f"{generated / wall:.1f} generated tokens/s over {wall:.2f} s; "
          f"{stats['steps']} decode steps, a step at [{SERVE_MAX_BATCH}, "
          f"{SERVE_BUF}] {step_ms:.3f} ms (CUDA events)")
    print(f"[serve] 10a reads: version 0 snapshot {snapshot_ms:.1f} ms "
          f"(transfer and decode), snapshots decoded while serving "
          f"{[round(x, 1) for x in source.read_ms]} ms, a snapshot's copy "
          f"to the card {copy_ms:.1f} ms; {stats['param_swaps']} hot "
          f"swaps (card bitwise the reader's tree; reader bitwise the "
          f"server's post-decode tree at version {sub.version}: "
          f"{ring_bitwise if ring is not None else 'out of the ring'}); "
          f"reads_served {fs['reads_served']}, read_shed "
          f"{fs['read_shed']}, delta_hits {fs['delta_hits']}, "
          f"delta_misses {fs['delta_misses']}; a full bf16 snapshot "
          f"{full_bytes:.0f} bytes, a delta between consecutive versions "
          f"{delta_bytes} bytes")
    print(f"[serve] 10a launches: front-end {counts['flash_fwd']} "
          f"flash_fwd over {stats['steps']} steps ({LM['n_layers']} a "
          f"step), PS {counts['block_dequant_sum']} block_dequant_sum over "
          f"{fills} fills; worker {g} gradients, {worker['counts']}; PS "
          f"fault stats: {format_fault_stats(fs)}; "
          f"{time.perf_counter() - t_start:.1f} s in all")
    del fe, srv


def serve_small_card_vs_cpu():
    """The front-end on a small f32 LM with the flash kernel, the card
    against the CPU (the plain version): every CPU token's top-2 logit
    margin exceeds 1e-4, then the tokens are equal."""
    import functools

    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch import flash_attention
    from pytorch_ps_mpi_tpu_torch.models import TransformerLM, build_lm
    from pytorch_ps_mpi_tpu_torch.serve import InferenceFrontend

    model = TransformerLM(**SERVE_SMALL, attn=functools.partial(
        flash_attention, causal=True))
    params = build_lm(model, seed=0)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, SERVE_SMALL["vocab_size"], size=n).tolist()
               for n in (3, 17, 64, 100, 9, 40)]
    got = {}
    for dev in ("cuda", "cpu"):
        fe = InferenceFrontend(model, params, max_batch=4, buf_len=128,
                               max_queue=8, device=dev)
        reqs = [fe.submit(p, max_new=12) for p in prompts]
        fe.drain()
        got[dev] = [r.result(0) for r in reqs]
    small = float("inf")
    for p, gen in zip(prompts, got["cpu"]):
        seq = torch.tensor([p + gen], dtype=torch.int32)
        with torch.inference_mode():
            logits = torch.func.functional_call(model, params, (seq,))[0]
        for j in range(len(gen)):
            top2 = torch.topk(logits[len(p) - 1 + j], 2).values
            small = min(small, float(top2[0] - top2[1]))
    if small <= SERVE_MARGIN:
        fail(f"serve card vs CPU: a top-2 margin of {small} is within "
             f"{SERVE_MARGIN}")
    if got["cuda"] != got["cpu"]:
        fail(f"serve card vs CPU: tokens {got['cuda']} against "
             f"{got['cpu']}")
    print(f"[serve] small f32 LM {SERVE_SMALL}, flash kernel: card tokens "
          f"equal the CPU's (plain version) on {len(prompts)} requests of 12"
          f" tokens; least top-2 margin {small:.4g} > {SERVE_MARGIN}")


def _wait_for_line(proc, path, pattern, what):
    """Wait (at most `MH_TIMEOUT`) until the process's stderr file holds a
    line matching ``pattern``."""
    end = time.monotonic() + MH_TIMEOUT
    while time.monotonic() < end:
        with open(path) as f:
            if re.search(pattern, f.read(), re.M):
                return
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    fail(f"{what}: no line {pattern!r}")


def serve_cli(tmp):
    """10b: ``--serve 0`` (the CLI's LM, bf16, flash, blockq, bf16
    parameter wire, delta snapshots), two ``--connect`` workers, one
    ``--subscribe --infer-serve`` reader and one plain ``--subscribe``,
    each a process with a timeout and its stderr in a file."""
    import os

    from pytorch_ps_mpi_tpu_torch import train

    common = CLI_LM + ["--codec", "blockq", "--quota", "2"]
    reader = [a for a in CLI_LM if a not in ("--attn", "flash")]
    t0 = time.perf_counter()
    srv, e = _mh_spawn(["-c", _CLI_BOOT, "default", *common, "--steps",
                        str(SERVE_CLI_STEPS), "--wire-codec", "bf16",
                        "--delta-parm", "--serve", "0"],
                       os.path.join(tmp, "cli-server.err"))
    port = _mh_port(srv, e, "serve CLI server")
    workers = [_mh_spawn(["-c", _MH_CLI_WORKER_BOOT, *common, "--connect",
                          f"127.0.0.1:{port}", "--reconnect-retries", "2"],
                         os.path.join(tmp, f"cli-worker{i}.err"))
               for i in range(2)]
    # The readers start once both workers have connected, so that they
    # read while the PS trains.
    for p, we in workers:
        _wait_for_line(p, we.name, r"^worker rank \d+ connected to ",
                       "serve CLI worker")
    readers = [_mh_spawn(["-c", _CLI_BOOT, "default", *reader,
                          "--subscribe", f"127.0.0.1:{port}", *extra,
                          "--reconnect-retries", "2"],
                         os.path.join(tmp, f"cli-reader{i}.err"))
               for i, extra in enumerate((
                   ["--infer-serve", "--steps", str(SERVE_CLI_REQUESTS)],
                   ["--steps", str(SERVE_CLI_POLLS)]))]
    lines = []
    for i, ((p, rerr), done) in enumerate(zip(readers, (
            r"^infer done: (\d+) served, (\d+) shed, .*$",
            r"^subscriber done: .*$"))):
        out, err = _mh_finish(p, rerr, f"serve CLI reader {i}")
        m = re.search(done, err, re.M)
        if not re.match(r"subscribed at version \d+$", out.strip()) \
                or m is None:
            fail(f"serve CLI reader {i}: no 'subscribed at version' or "
                 f"'done' line")
        if i == 0 and (int(m.group(1)), int(m.group(2))) != (
                SERVE_CLI_REQUESTS, 0):
            fail(f"serve CLI: the inference reader's {m.group(0)!r}")
        lines.append(f"{out.strip()}; {m.group(0)}")
    args = train.make_parser().parse_args(CLI_LM)
    n_leaves = len(train._build_lm_async(args)[0])
    for i, (p, we) in enumerate(workers):
        out, _ = _mh_finish(p, we, f"serve CLI worker {i}")
        r = _mh_worker_result(out, f"serve CLI worker {i}")
        g = r["computed"]
        expect_counts(f"serve CLI worker rank {r['rank']}", r["counts"],
                      flash_fwd=4 * g, flash_bwd_dkdv=4 * g,
                      flash_bwd_dq=4 * g, block_quantize=n_leaves * g)
    _, err = _mh_finish(srv, e, "serve CLI server")
    m = re.search(r"^done: (\d+) updates, (\d+) grads", err, re.M)
    stats = re.search(r"^fault stats: (.*)$", err, re.M)
    if m is None or int(m.group(1)) != SERVE_CLI_STEPS or stats is None \
            or "reads_served=" not in stats.group(1):
        fail("serve CLI server: no 'done:' line or no reads served")
    for line in lines:
        print(f"[serve] 10b {line}")
    print(f"[serve] 10b server: {m.group(0)}; {stats.group(1)}; "
          f"{time.perf_counter() - t0:.1f} s in all")


def run_serve_phase():
    """Phase 10: the serve tier on a single PS (10a, the card against the
    CPU on a small LM, 10b)."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ps_serve_")
    try:
        serve_bench_lm(tmp)
        torch.cuda.empty_cache()
        serve_small_card_vs_cpu()
        serve_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[serve] phase 10 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 11: the sharded PS fleet on the card
# ---------------------------------------------------------------------------

# 11b: shard 1 is killed before this update of the 44 and promoted from
# its hot standby.  Replicating every update holds each shard's serve loop
# for a REPL round trip (160-360 ms on an H100 host) while the router keeps
# computing gradients: they queue up (staleness mean 8.15-9.05 in two runs
# of 11a's configuration, whose loss rose over its last fifth in one).
# 11b bounds admission at staleness 2 (the CLI's --max-staleness), where
# 11a runs (staleness mean ~2.2), so that its loss check reads training,
# not the backlog.
FLEET_KILL_AT, FLEET_MAX_STALENESS = 20, 2
# 11c: the CLI's LM on a 2-shard fleet with standbys and snapshots, then
# resumed from the manifest for the rest.
FLEET_CLI_STEPS, FLEET_CLI_RESUMED, FLEET_CLI_REQUESTS = 8, 10, 4
_FLEET_SUBSCRIBED = r"subscribed at version \((\d+), (\d+)\)$"


def _lockstep_links(router):
    """Each link's pull repeats until its shard has applied the previous
    gradient: with quota 1 a shard, sequential SGD through the fleet."""
    for link in router.links:
        orig, last = link.pull, {"v": None}

        def pull(force=False, orig=orig, last=last):
            while True:
                got = orig(force)
                if (got is None or last["v"] is None
                        or got[0] > last["v"]):
                    if got is not None:
                        last["v"] = got[0]
                    return got
                time.sleep(0.001)

        link.pull = pull


def _fleet_thread(fleet, steps, **kw):
    """``fleet.serve(steps)`` on a thread of this process: (thread, box)."""
    import threading

    box = {}

    def run():
        try:
            box["hist"] = fleet.serve(steps=steps, idle_timeout=MH_TIMEOUT,
                                      **kw)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the caller
            box["error"] = exc

    t = threading.Thread(target=run, name="fleet-serve")
    t.start()
    return t, box


def _host_state(srv) -> dict:
    sd = srv.state_dict()
    return {"params": sd["params"], "state": sd["state"]}


def _same_state(a, b) -> bool:
    import numpy as np

    return (a["params"].keys() == b["params"].keys() and all(
        np.array_equal(a["params"][n], b["params"][n])
        and all(np.array_equal(a["state"][n][k], b["state"][n][k])
                for k in a["state"][n])
        for n in a["params"]))


def _instrument_failover(fleet, box):
    """11b's probes, on this run's objects: each primary's REPL round trip
    (ms), the publish times of shard 1's primary and its standby, and at
    the promotion the successor's state, the dead primary's and the
    replicated blob."""
    for srv in fleet.servers:
        orig = srv._replicate

        def timed(step, orig=orig):
            t0 = time.perf_counter()
            orig(step)
            box["repl_ms"].append(1e3 * (time.perf_counter() - t0))

        srv._replicate = timed
    old, sb = fleet.servers[1], fleet.standbys[1]
    for srv in (old, sb):
        orig = srv._publish

        def stamped(orig=orig):
            orig()
            box["published"].append(time.perf_counter())

        srv._publish = stamped
    orig_promote = sb.promote_from_replica

    def capture():
        step = orig_promote()
        with sb._repl_lock:
            box["blob"] = (sb._repl_blob, sb._repl_codec)
        box["successor"] = _host_state(sb)
        box["primary"] = _host_state(old)
        box["promoted_at"] = time.perf_counter()
        return step

    sb.promote_from_replica = capture


def fleet_resnet_run(what, named, loss_fn, tmp, *, run1a_ips, replicas=0,
                     kill_at=None, max_staleness=None):
    """11a/11b: a 2-shard `PSFleet` (size-balanced greedy, quota 1 a shard,
    ResNet-18 blockq, momentum 0.9) in this process on the card, one
    router worker process (``chip_smoke.py --mh-worker`` with the fleet's
    ports); 4 warm-up and 40 timed updates a shard.  With ``kill_at``
    (11b: ``replicas=1``, replication every update), shard 1 dies before
    that update and its standby is promoted onto its port.  Returns
    images/s over shard 0's timed window (a gradient a fill a shard)."""
    import os

    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.ops.codecs import decode_wire_tree
    from pytorch_ps_mpi_tpu_torch.shard import PSFleet
    from pytorch_ps_mpi_tpu_torch.utils import checkpoint
    from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan
    from pytorch_ps_mpi_tpu_torch.utils.interop import jax_tree_order
    from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

    updates = ASYNC_WARM + ASYNC_TIMED
    plan = (FaultPlan(kill_shard_at={1: kill_at}) if kill_at is not None
            else None)
    fleet = PSFleet(list(jax_tree_order(named).items()), num_shards=2,
                    quota=1, lr=ASYNC_LR, momentum=0.9, code="blockq",
                    device="cuda", replicas=replicas, fault_plan=plan,
                    max_staleness=max_staleness)
    fleet.compile_step(loss_fn)
    probes = {"repl_ms": [], "published": []}
    if kill_at is not None:
        _instrument_failover(fleet, probes)
    spec = {"ports": [p for _, p in fleet.addresses], "code": "blockq",
            "retries": 20 if kill_at is not None else 2}
    tag = "fleet-kill" if kill_at is not None else "fleet"
    proc = _mh_spawn([os.path.abspath(__file__), "--mh-worker",
                      json.dumps(spec)], os.path.join(tmp, f"{tag}.err"))
    torch.cuda.synchronize()
    reset_launch_counts()
    t, box = _fleet_thread(fleet, updates, warmup_steps=ASYNC_WARM)
    t.join(MH_TIMEOUT + 60)
    counts = launch_counts()
    try:
        hist = _mh_joined(t, box, what)
    finally:
        try:
            result = _mh_worker_result(_mh_finish(proc[0], proc[1],
                                                  what)[0], what)
        finally:
            fleet.close()
    per = hist["per_shard"]
    n_fills = [len(h["losses"]) for h in per]
    restored = [s["restored_base"] for s in fleet._slots]
    fills = [n + r for n, r in zip(n_fills, restored)]
    if fills != [updates, updates]:
        fail(f"{what}: shards applied {fills} updates, expected {updates}")
    leaves = [len(fleet.plan.names_for(k)) for k in range(2)]
    # A promoted standby compiles at its promotion: one encode of a zero
    # tree (a block_quantize a leaf) gives it the codes' structure.
    expect_counts(f"{what}, the fleet", counts, block_dequant_sum=sum(
        f * ck.group_launches("block_dequant_sum", n)
        for f, n in zip(fills, leaves)),
        block_quantize=hist["fault_stats"]["promotions"] * leaves[1])
    expect_counts(f"{what}, the router", result["counts"],
                  block_quantize=len(named) * result["computed"])
    for srv in fleet.servers:
        check_params_finite(srv, what)
    losses = per[0]["losses"][ASYNC_WARM:]
    first, last = _fifths(losses)
    ips = ASYNC_TIMED * ASYNC_BATCH / per[0]["steady_wall_time"]
    fs = hist["fault_stats"]
    d = fleet.describe()
    shards = []
    for k in range(2):
        sfs = fs["shards"][str(k)]
        parm = sfs["parm_bytes_wire"] / max(1, sfs["parm_encodes"])
        grad = float(np.mean([x["msg_bytes"]
                              for x in fleet.servers[k].timings]))
        stale = per[k]["staleness"][ASYNC_WARM:] or per[k]["staleness"]
        shards.append(
            f"shard {k}: {d['shards'][k]['leaves']} leaves, "
            f"{d['shards'][k]['bytes']} bytes, {fills[k]} updates, PARM "
            f"{parm / 1e6:.3f} MB, GRAD {grad / 1e6:.3f} MB an update, "
            f"staleness mean {sum(stale) / len(stale):.3f} max "
            f"{max(stale):.3f}")
    print(f"[fleet] {what}: {ASYNC_TIMED} timed updates a shard, "
          f"{ips:.1f} images/s (phase 7's run 1a {run1a_ips:.1f} in this "
          f"call: ratio {ips / run1a_ips:.3f}), loss first/last fifth "
          f"{first:.4f} / {last:.4f}; router rank {result['rank']}, "
          f"{result['computed']} gradients, "
          f"{result['counts']['block_quantize']} block_quantize; fleet "
          f"launches {counts}; plan digest {d['digest']:#x}")
    for line in shards:
        print(f"[fleet] {what}: {line}")
    print(f"[fleet] {what}: fault stats {format_fault_stats(fs)}; router "
          f"{result['fault_stats']}")
    falling = all(math.isfinite(v) for v in losses) and last < first
    if kill_at is None:
        if not falling:
            fail(f"{what}: losses {per[0]['losses']}")
        return ips
    # 11b: one promotion, zero rewind, the successor bitwise the blob.
    if fs["promotions"] != 1 or fs["shard_restores"] != 0:
        fail(f"{what}: promotions {fs['promotions']}, restores "
             f"{fs['shard_restores']}")
    if restored[1] != kill_at or per[1]["versions"][0] != kill_at + 1:
        fail(f"{what}: the successor resumed at {restored[1]}, its first "
             f"version {per[1]['versions'][:1]}")
    blob, codec = probes["blob"]
    arrays = decode_wire_tree(codec, checkpoint.loads_tree(blob))
    if not _same_state(probes["successor"], arrays):
        fail(f"{what}: the successor's state is not the replicated blob")
    if not _same_state(probes["successor"], probes["primary"]):
        fail(f"{what}: the successor's state is not the primary's at "
             f"update {kill_at}")
    live = fleet.servers[1]._fault_stats_snapshot()
    if (result["rank"] != 0 or live["live_ranks"] != [0]
            or live["workers_seen"] != 1 or result["reconnects"] < 1):
        fail(f"{what}: the router's rank {result['rank']}, reconnects "
             f"{result['reconnects']}, the successor's ranks "
             f"{live['live_ranks']} ({live['workers_seen']} seen)")
    pub = probes["published"]
    gaps = np.diff(pub)
    gap = gaps[kill_at - 1]
    usual = float(np.median(np.delete(gaps, kill_at - 1)))
    repl = probes["repl_ms"]
    print(f"[fleet] {what}: promoted at replicated step {kill_at} (zero "
          f"rewind; the successor bitwise the blob and the primary); "
          f"repl_sent {fs['repl_sent']}, repl_received "
          f"{fs['repl_received']}, repl_lag {fs['repl_lag']}; a REPL round "
          f"trip {float(np.median(repl)):.1f} ms median ({min(repl):.1f}-"
          f"{max(repl):.1f}, {len(repl)} of them); shard 1's update "
          f"{kill_at} to {kill_at + 1}: {1e3 * gap:.1f} ms against a "
          f"median {1e3 * usual:.1f} ms between updates "
          f"({gap / usual:.1f} updates' time), the promotion "
          f"{1e3 * (probes['promoted_at'] - pub[kill_at - 1]):.1f} ms after"
          f" the last update of the primary")
    if not falling:
        fail(f"{what}: losses {per[0]['losses']}, staleness "
             f"{per[0]['staleness']}")
    return ips


def fleet_cli(tmp):
    """11c: ``--serve 0 --shards 2 --replicas 1 --snapshot-every 5 --save``
    (the CLI's LM, bf16, flash, blockq, quota 2), two ``--connect
    h:p0,h:p1`` workers, a ``--subscribe h:p0,h:p1 --infer-serve`` reader;
    then ``--resume`` from the manifest with one worker, for updates 9-10
    (the versions continue).  Each a process with a timeout and its stderr
    in a file; each worker's launch counts: 4 of each flash kernel and a
    ``block_quantize`` a leaf per gradient."""
    import os

    from pytorch_ps_mpi_tpu_torch import train
    from pytorch_ps_mpi_tpu_torch.native import serializer
    from pytorch_ps_mpi_tpu_torch.shard import FleetManifest
    from pytorch_ps_mpi_tpu_torch.shard.fleet import (fleet_manifest_path,
                                                      shard_checkpoint_path)

    ckpt = os.path.join(tmp, "fleet_lm.psz")
    common = CLI_LM + ["--codec", "blockq", "--quota", "2"]
    reader = [a for a in CLI_LM if a not in ("--attn", "flash")]
    args = train.make_parser().parse_args(CLI_LM)
    n_leaves = len(train._build_lm_async(args)[0])
    t0 = time.perf_counter()

    def server(extra, log):
        proc, err = _mh_spawn(["-c", _CLI_BOOT, "default", *common,
                               "--serve", "0", "--shards", "2", "--save",
                               ckpt, *extra], os.path.join(tmp, log))
        m = _mh_first_line(proc, err, r"serving on ports (\d+) (\d+)$",
                           f"fleet CLI {log}")
        return proc, err, f"127.0.0.1:{m.group(1)},127.0.0.1:{m.group(2)}"

    def workers(connect, n, tag):
        return [_mh_spawn(["-c", _MH_CLI_WORKER_BOOT, *common,
                           "--connect", connect, "--reconnect-retries", "2"],
                          os.path.join(tmp, f"fleet-{tag}{i}.err"))
                for i in range(n)]

    def finish_workers(procs, what):
        out = []
        for i, (p, e) in enumerate(procs):
            r = _mh_worker_result(_mh_finish(p, e, f"{what} {i}")[0], what)
            g = r["computed"]
            expect_counts(f"{what} rank {r['rank']}", r["counts"],
                          flash_fwd=4 * g, flash_bwd_dkdv=4 * g,
                          flash_bwd_dq=4 * g, block_quantize=n_leaves * g)
            out.append((r["rank"], g))
        return out

    srv, e, connect = server(["--replicas", "1", "--snapshot-every", "5",
                              "--steps", str(FLEET_CLI_STEPS)],
                             "fleet-server.err")
    # The reader starts with the workers: it subscribes in the seconds
    # their start and first gradients take, before the fleet's run ends.
    rd, rerr = _mh_spawn(["-c", _CLI_BOOT, "default", *reader, "--subscribe",
                          connect, "--infer-serve", "--steps",
                          str(FLEET_CLI_REQUESTS), "--reconnect-retries",
                          "2"], os.path.join(tmp, "fleet-reader.err"))
    ws = workers(connect, 2, "worker")
    sub = _mh_first_line(rd, rerr, _FLEET_SUBSCRIBED, "fleet CLI reader")
    _, rtext = _mh_finish(rd, rerr, "fleet CLI reader")
    ranks = finish_workers(ws, "fleet CLI worker")
    _, stext = _mh_finish(srv, e, "fleet CLI server")
    m = re.search(r"^infer done: (\d+) served, (\d+) shed, .*$", rtext,
                  re.M)
    if m is None or int(m.group(1)) != FLEET_CLI_REQUESTS:
        fail(f"fleet CLI reader: {m.group(0) if m else 'no done line'}")
    done = re.search(r"^done: (\d+) shard-updates across 2 shards .*$",
                     stext, re.M)
    stats = re.search(r"^fault stats: (.*)$", stext, re.M)
    want = 2 * FLEET_CLI_STEPS
    if (done is None or int(done.group(1)) != want or stats is None
            or f"repl_sent={want}" not in stats.group(1)):
        fail(f"fleet CLI server: {done and done.group(0)}, "
             f"{stats and stats.group(1)}")
    with open(fleet_manifest_path(ckpt), "rb") as f:
        manifest = FleetManifest.from_json(f.read())
    if manifest.cut != FLEET_CLI_STEPS or manifest.skewed_entries():
        fail(f"fleet CLI: manifest at cut {manifest.cut}")
    # --resume from the manifest: every shard at the cut, the versions go
    # on from it.
    srv, e, connect = server(["--resume", ckpt, "--steps",
                              str(FLEET_CLI_RESUMED)],
                             "fleet-server2.err")
    ranks2 = finish_workers(workers(connect, 1, "resumed"),
                            "fleet CLI resumed worker")
    _, stext2 = _mh_finish(srv, e, "fleet CLI server (resumed)")
    if f"resumed fleet shards at steps [{FLEET_CLI_STEPS}, " \
            f"{FLEET_CLI_STEPS}]" not in stext2:
        fail("fleet CLI: not resumed from the manifest's cut")
    versions = []
    for k in range(2):
        with open(shard_checkpoint_path(ckpt, k), "rb") as f:
            _, meta = serializer.loads(f.read(), with_meta=True)
        versions.append((meta["step"], meta["extra"]["served_version"]))
    if versions != [(FLEET_CLI_RESUMED, FLEET_CLI_RESUMED)] * 2:
        fail(f"fleet CLI: after the resume the shards hold {versions}")
    print(f"[fleet] 11c server: {done.group(0)}; {stats.group(1)}; "
          f"workers (rank, gradients) {ranks} with 4 of each flash kernel "
          f"and {n_leaves} block_quantize a gradient; manifest at cut "
          f"{manifest.cut}")
    print(f"[fleet] 11c reader: {sub.group(0)}; {m.group(0)}")
    print(f"[fleet] 11c resumed: shards at [{FLEET_CLI_STEPS}, "
          f"{FLEET_CLI_STEPS}] from the manifest, worker {ranks2}, final "
          f"(step, served version) {versions}; "
          f"{time.perf_counter() - t0:.1f} s in all")


def fleet_card_vs_cpu():
    """11d: a 2-shard fleet (quota 1 a shard) and one lockstep router
    (sequential SGD through the fleet), the small MLP, 6 identity and 2
    blockq updates, on the card against the same conversation on the CPU:
    params within run 3's rtol 1e-4 / atol 1e-5, at most one element in
    10,000 outside."""
    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch.async_ps import dataset_batch_fn
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_mnist
    from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
    from pytorch_ps_mpi_tpu_torch.shard import PSFleet, ShardRouter

    named = init_mlp(np.random.RandomState(0), (784, 64, 10))
    x, y = synthetic_mnist(256, seed=1)
    for code, updates in (("identity", 6), ("blockq", 2)):
        out = {}
        for device in ("cuda", "cpu"):
            fleet = PSFleet(list(named.items()), num_shards=2, quota=1,
                            lr=0.05, momentum=0.9, code=code, device=device)
            fleet.compile_step(mlp_loss_fn)
            torch.cuda.synchronize()
            reset_launch_counts()
            t, box = _fleet_thread(fleet, updates)
            try:
                router = ShardRouter(fleet.addresses, code=code,
                                     device=device, reconnect_retries=1)
                _lockstep_links(router)
                router.run(mlp_loss_fn, dataset_batch_fn(x, y, 64, seed=2))
                hist = _mh_joined(t, box, f"fleet MLP {code} {device}")
            finally:
                fleet.close()
            torch.cuda.synchronize()
            counts = launch_counts()
            out[device] = (hist["per_shard"][0]["losses"],
                           {n: p.cpu().numpy() for srv in fleet.servers
                            for n, p in srv.params.items()})
            if device == "cuda" and code == "blockq":
                expect_counts(f"fleet MLP {code} on the card", counts,
                              block_quantize=len(named) * updates,
                              block_dequant_sum=2 * updates)
        a, b = out["cuda"][1], out["cpu"][1]
        outside = sum(int((~np.isclose(a[n], b[n], rtol=1e-4,
                                       atol=1e-5)).sum()) for n in b)
        total = sum(v.size for v in b.values())
        print(f"[fleet] 11d lockstep MLP {code}, 2 shards, {updates} "
              f"updates, card vs CPU: losses {out['cuda'][0]} vs "
              f"{out['cpu'][0]}, max difference {_np_max_diff(a, b)}, "
              f"{outside} of {total} elements outside rtol 1e-4 / atol "
              f"1e-5")
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
        if outside > (0 if code == "identity" else 1e-4 * total):
            fail(f"fleet MLP {code} card vs CPU: {outside} elements apart")


def run_fleet_phase(run1a_ips):
    """Phase 11: the sharded PS fleet on the card (11a-11d)."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ps_fleet_")
    try:
        named, loss_fn, _ = _async_resnet18()
        ips = fleet_resnet_run(
            "ResNet-18 blockq, 2 shards, 1 router process, quota 1 (11a)",
            named, loss_fn, tmp, run1a_ips=run1a_ips)
        killed = fleet_resnet_run(
            f"11a with a hot standby a shard, shard 1 killed before update "
            f"{FLEET_KILL_AT}, staleness bound {FLEET_MAX_STALENESS} (11b)",
            named, loss_fn, tmp, run1a_ips=run1a_ips, replicas=1,
            kill_at=FLEET_KILL_AT, max_staleness=FLEET_MAX_STALENESS)
        print(f"[fleet] 11b: {killed:.1f} images/s against 11a's {ips:.1f} "
              f"(ratio {killed / ips:.3f}: replication every update and "
              f"the promotion)")
        del named, loss_fn
        torch.cuda.empty_cache()
        fleet_cli(tmp)
        fleet_card_vs_cpu()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[fleet] phase 11 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 12: the two-level hierarchy on the card
# ---------------------------------------------------------------------------

# 12a/12b: 4 worker processes in 2 groups of 2 behind 2 aggregators (group
# size 2, mean), the root at quota 2: a root update sums 4 gradients, as
# run 1b's quota 4 does, so the step per gradient is run 1b's.
HIER_GROUPS, HIER_GROUP_SIZE = 2, 2
# 12b: group 0's aggregator dies before its fill 10 and is restarted in
# place; its workers redial (20 tries at 0.05-0.5 s) on their local ranks.
HIER_KILL_AT = 10
# 12c: the CLI's LM through 2 aggregators (group size 1) over a 2-shard
# fleet, this many root updates.
HIER_CLI_STEPS = 4
_HIER_AGG_PORTS = r"aggregators on ports (\d+) (\d+)$"
# 12c's server: the CLI with the launch counts zeroed just before, then
# the launch counts and the fleet's groups entry on one line.
_HIER_CLI_BOOT = (
    "import json, sys, torch\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "from pytorch_ps_mpi_tpu_torch import train\n"
    "from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck\n"
    "from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa\n"
    "ck.reset_launch_counts()\n"
    "fa.reset_launch_counts()\n"
    "root = train.main(sys.argv[1:])\n"
    "torch.cuda.synchronize()\n"
    "print('HIER_ROOT ' + json.dumps({'counts': {**ck.LAUNCHES, "
    "**fa.LAUNCHES}, 'groups': root.fleet_fault_stats()['groups']}), "
    "flush=True)\n")


def _stamp_publishes(srv, box):
    """Record the time of each of ``srv``'s publishes in ``box``."""
    orig = srv._publish

    def stamped():
        orig()
        box.append(time.perf_counter())

    srv._publish = stamped


def _hier_thread(hier):
    """``hier.serve()`` on a thread of this process: (thread, box)."""
    import threading

    box = {}

    def run():
        try:
            box["view"] = hier.serve(idle_timeout=MH_TIMEOUT)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the caller
            box["error"] = exc

    t = threading.Thread(target=run, name="hier-serve")
    t.start()
    return t, box


def hier_resnet_run(what, named, loss_fn, tmp, *, run1b_ips, run1b_grad,
                    kill_at=None):
    """12a/12b: the root `AsyncSGDServer` (ResNet-18 blockq, momentum 0.9,
    run 1b's lr, quota 2) and a `Hierarchy` of 2 aggregators (group size
    2, mean) as threads of this process on the card, 4 worker processes
    (``chip_smoke.py --mh-worker``, 2 an aggregator); 4 warm-up and 40
    timed root updates.  The launch counts of this process (the root's
    and the aggregators') are read around the run, each worker's in its
    process.  With ``kill_at`` (12b) group 0's aggregator dies before that
    fill and is restarted on its port with its upstream rank.  Returns
    images/s over the timed window."""
    import os

    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch.multihost_async import AsyncSGDServer
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.shard import Hierarchy
    from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan
    from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

    updates = ASYNC_WARM + ASYNC_TIMED
    workers = HIER_GROUPS * HIER_GROUP_SIZE
    root = AsyncSGDServer(list(named.items()), lr=ASYNC_LR / workers,
                          momentum=0.9, quota=HIER_GROUPS, code="blockq",
                          device="cuda")
    root.compile_step(loss_fn)
    published: list = []
    _stamp_publishes(root, published)
    t, box = _serve_thread(root, updates, warmup_steps=ASYNC_WARM)
    plan = (FaultPlan(kill_agg_at={0: kill_at}) if kill_at is not None
            else None)
    hier = Hierarchy(list(named.items()), groups=HIER_GROUPS,
                     group_size=HIER_GROUP_SIZE,
                     upstream=[("127.0.0.1", root.address[1])],
                     code="blockq", device="cuda", fault_plan=plan,
                     max_restarts=2)
    hier.compile()
    agg0 = hier.aggregators[0]
    up_rank0, port0 = agg0.upstream_rank, agg0.address[1]
    tag = "hier-kill" if kill_at is not None else "hier"
    procs = []
    for g, (_, port) in enumerate(hier.addresses):
        spec = {"port": port, "code": "blockq"}
        if kill_at is not None:
            spec["retries"] = 20
        procs += [(g, *_mh_spawn(
            [os.path.abspath(__file__), "--mh-worker", json.dumps(spec)],
            os.path.join(tmp, f"{tag}-g{g}w{i}.err")))
            for i in range(HIER_GROUP_SIZE)]
    sampler = _UtilSampler(os.path.join(tmp, f"{tag}-util.txt"))
    torch.cuda.synchronize()
    reset_launch_counts()
    ht, hbox = _hier_thread(hier)
    while t.is_alive() and root._served_version < ASYNC_WARM:
        time.sleep(0.005)
    sampler.start()
    try:
        try:
            hist = _mh_joined(t, box, what)
        finally:
            util = sampler.stop()
        ht.join(MH_TIMEOUT + 60)
        if ht.is_alive():
            fail(f"{what}: the hierarchy did not end")
        if "error" in hbox:
            raise hbox["error"]
        view = hbox["view"]
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        try:
            results = [(g, _mh_worker_result(_mh_finish(p, e, what)[0],
                                             what)) for g, p, e in procs]
        finally:
            hier.close()
            root.close()
    tier = view["fault_stats"]
    fills = tier["agg_forwards"]  # every incarnation's, the retired too
    fs = hist["fault_stats"]
    agg_ranks = sorted(g["aggregator_rank"] for g in fs["groups"].values())
    # The root's fills: 2 AGGR frames an update, each an aggregator's (a
    # mean fill is not rank-distinct: a late frame of one group may share
    # a fill with that group's next one).
    if any(len(c) != HIER_GROUPS or not set(c) <= set(agg_ranks)
           for c in hist["contributors"]) or len(agg_ranks) != HIER_GROUPS:
        fail(f"{what}: root fills {hist['contributors']}, aggregators "
             f"{agg_ranks}")
    mixed = sum(len(set(c)) == HIER_GROUPS for c in hist["contributors"])
    if fs["agg_frames"] < HIER_GROUPS * updates:
        fail(f"{what}: agg_frames {fs['agg_frames']} for {updates} updates")
    # This process: one grouped decode a root fill; one grouped decode and
    # a block_quantize a leaf an aggregator fill (the re-encoded mean).
    expect_counts(f"{what}, the root and the aggregators", counts,
                  block_dequant_sum=(updates + fills) * ck.group_launches(
                      "block_dequant_sum", len(named)),
                  block_quantize=len(named) * fills)
    for g, r in results:
        expect_counts(f"{what}, group {g} worker rank {r['rank']}",
                      r["counts"], block_quantize=len(named) * r["computed"])
    check_params_finite(root, what)
    losses = hist["losses"][ASYNC_WARM:]
    first, last = _fifths(losses)
    ips = ASYNC_TIMED * workers * ASYNC_BATCH / hist["steady_wall_time"]
    stale = hist["staleness"][ASYNC_WARM:]
    timed = root.timings[ASYNC_WARM:]
    aggr = float(np.mean([d["msg_bytes"] for d in timed]))
    per_fill = [sum(len(c) for c in h["contributors"])
                / max(1, len(h["contributors"]))
                for h in view["per_group"] if h]
    print(f"[hier] {what}: {ASYNC_TIMED} timed root updates, {ips:.1f} "
          f"images/s (run 1b's {run1b_ips:.1f} in this call: ratio "
          f"{ips / run1b_ips:.3f}), loss first/last fifth {first:.4f} / "
          f"{last:.4f}, root staleness mean {sum(stale) / len(stale):.3f} "
          f"max {max(stale):.3f}; the root's AGGR bytes an update "
          f"{HIER_GROUPS * aggr / 1e6:.3f} MB ({HIER_GROUPS} frames of "
          f"{aggr / 1e6:.3f} MB) against run 1b's GRAD "
          f"{run1b_grad / 1e6:.3f} MB an update")
    print(f"[hier] {what}: agg_frames {fs['agg_frames']} for {updates} "
          f"root updates ({mixed} of them a frame from each aggregator, "
          f"the rest two of one); {fills} group fills "
          f"({tier['agg_paced']} paced), "
          f"contributors a fill {per_fill}; launches here {counts}; "
          f"workers (group, rank, gradients, block_quantize) "
          f"{[(g, r['rank'], r['computed'], r['counts']['block_quantize']) for g, r in results]}")
    computed = sum(r["computed"] for _, r in results)
    print(f"[hier] {what}: the workers computed {computed} gradients for "
          f"the {workers * updates} the root's updates stand for "
          f"({computed / (workers * updates):.2f}x); nvidia-smi "
          f"utilization.gpu over the timed window "
          + (f"mean {sum(util) / len(util):.1f} %, {len(util)} samples at "
             f"100 ms" if util else "not measured"))
    print(f"[hier] {what}: the root's groups view {fs['groups']}")
    print(f"[hier] {what}: root fault stats {format_fault_stats(fs)}; tier "
          f"{format_fault_stats(tier)}")
    if not all(math.isfinite(v) for v in losses) or not last < first:
        fail(f"{what}: losses {hist['losses']}, root staleness "
             f"{hist['staleness']}")
    if kill_at is None:
        return ips
    # 12b: one restart in place, no churn at either level.
    live = hier.aggregators[0]._fault_stats_snapshot()
    g0 = sorted(r["rank"] for g, r in results if g == 0)
    redials = [r["reconnects"] for g, r in results if g == 0]
    if (tier["agg_restarts"] != 1
            or hier.aggregators[0].upstream_rank != up_rank0
            or hier.addresses[0][1] != port0
            or fs["groups"]["0"]["aggregator_rank"] != up_rank0
            or fs["workers_seen"] != HIER_GROUPS
            or fs["duplicate_dropped"] != 0
            or g0 != list(range(HIER_GROUP_SIZE))
            or live["workers_seen"] != 0
            or min(redials) < 1):
        fail(f"{what}: restarts {tier['agg_restarts']}, upstream rank "
             f"{hier.aggregators[0].upstream_rank} (was {up_rank0}), root "
             f"workers_seen {fs['workers_seen']}, duplicate_dropped "
             f"{fs['duplicate_dropped']}, group 0's worker ranks {g0} "
             f"(redials {redials}), the successor's workers_seen "
             f"{live['workers_seen']}")
    gaps = np.diff(published[ASYNC_WARM:])
    worst = int(np.argmax(gaps))
    usual = float(np.median(gaps))
    print(f"[hier] {what}: restarted once on port {port0} with upstream "
          f"rank {up_rank0}; the root booked {fs['workers_seen']} ranks "
          f"ever, duplicate_dropped 0; group 0's workers kept local ranks "
          f"{g0} after {redials} reconnects; the longest gap between root "
          f"updates {1e3 * float(gaps[worst]):.1f} ms (after timed update "
          f"{worst + 1}) against a median {1e3 * usual:.1f} ms "
          f"({float(gaps[worst]) / usual:.1f} updates' time)")
    return ips


def hier_cli(tmp):
    """12c: ``--serve 0 --shards 2 --aggregators 2 --group-size 1`` (the
    CLI's LM, flash, blockq; the root's quota is the aggregators' count)
    and two ``--connect <aggregator g> --group g --fallback <root
    endpoints>`` workers, each a process with a timeout and its stderr in
    a file.  Each worker: 4 of each flash kernel and a ``block_quantize``
    a leaf per gradient.  The server: one ``block_dequant_sum`` a fill on
    each shard and on each aggregator, a ``block_quantize`` a leaf an
    aggregator fill and one a leaf at the shards' compile."""
    import os

    from pytorch_ps_mpi_tpu_torch import train

    common = CLI_LM + ["--codec", "blockq"]
    args = train.make_parser().parse_args(CLI_LM)
    n_leaves = len(train._build_lm_async(args)[0])
    t0 = time.perf_counter()
    srv, e = _mh_spawn(["-c", _HIER_CLI_BOOT, *common, "--serve", "0",
                        "--shards", "2", "--aggregators", str(HIER_GROUPS),
                        "--group-size", "1", "--steps",
                        str(HIER_CLI_STEPS)],
                       os.path.join(tmp, "hier-server.err"))
    m = _mh_first_line(srv, e, r"serving on ports (\d+) (\d+)$",
                       "hierarchy CLI server")
    roots = f"127.0.0.1:{m.group(1)},127.0.0.1:{m.group(2)}"
    ports = _mh_first_line(srv, e, _HIER_AGG_PORTS, "hierarchy CLI server")
    ws = [_mh_spawn(["-c", _MH_CLI_WORKER_BOOT, *common, "--connect",
                     f"127.0.0.1:{ports.group(g + 1)}", "--group", str(g),
                     "--fallback", roots, "--reconnect-retries", "2"],
                    os.path.join(tmp, f"hier-worker{g}.err"))
          for g in range(HIER_GROUPS)]
    lines = []
    for g, (p, we) in enumerate(ws):
        out, text = _mh_finish(p, we, f"hierarchy CLI worker {g}")
        r = _mh_worker_result(out, f"hierarchy CLI worker {g}")
        n = r["computed"]
        expect_counts(f"hierarchy CLI worker {g}", r["counts"],
                      flash_fwd=4 * n, flash_bwd_dkdv=4 * n,
                      flash_bwd_dq=4 * n, block_quantize=n_leaves * n)
        done = re.search(r"^group worker done: (\d+) gradients pushed$",
                         text, re.M)
        if done is None or "agg_failovers" in text:
            fail(f"hierarchy CLI worker {g}: {text[-2000:]}")
        lines.append(f"group {g}: {done.group(0)} ({n} computed)")
    out, stext = _mh_finish(srv, e, "hierarchy CLI server")
    m = re.search(r"^HIER_ROOT (.*)$", out, re.M)
    done = re.search(r"^done: (\d+) root updates, (\d+) group fills across "
                     r"2 aggregators in [\d.]+s$", stext, re.M)
    tier = re.search(r"^aggregator tier: .*\bagg_forwards=(\d+)", stext,
                     re.M)
    if m is None or done is None or tier is None \
            or int(done.group(1)) != HIER_CLI_STEPS:
        fail(f"hierarchy CLI server: {stext[-3000:]}")
    root = json.loads(m.group(1))
    fills = int(tier.group(1))
    expect_counts("hierarchy CLI server", root["counts"],
                  block_dequant_sum=2 * HIER_CLI_STEPS + fills,
                  block_quantize=n_leaves * (fills + 1))
    groups = root["groups"]
    if sorted(groups) != ["0", "1"] or any(
            v["agg_frames"] < 2 * HIER_CLI_STEPS for v in groups.values()):
        fail(f"hierarchy CLI: the fleet's groups entry {groups}")
    print(f"[hier] 12c server: {done.group(0)}; launches {root['counts']}")
    print(f"[hier] 12c workers: {'; '.join(lines)}")
    print(f"[hier] 12c the fleet's groups entry: {groups}; "
          f"{time.perf_counter() - t0:.1f} s in all")


def hier_card_vs_cpu():
    """12d: a 1-group hierarchy over a single root (quota 1, group size
    1) and one lockstep worker (each pull, the worker's and the
    aggregator's upstream one, waits for the previous gradient's update:
    sequential SGD), the small MLP, 6 identity and 2 blockq updates, on the
    card against the same conversation on the CPU: params within run 3's
    rtol 1e-4 / atol 1e-5, at most one element in 10,000 outside."""
    import numpy as np
    import torch

    from pytorch_ps_mpi_tpu_torch.async_ps import dataset_batch_fn
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_mnist
    from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
    from pytorch_ps_mpi_tpu_torch.multihost_async import (AsyncPSWorker,
                                                          AsyncSGDServer)
    from pytorch_ps_mpi_tpu_torch.shard import Hierarchy

    named = init_mlp(np.random.RandomState(0), (784, 64, 10))
    x, y = synthetic_mnist(256, seed=1)
    for code, updates in (("identity", 6), ("blockq", 2)):
        out = {}
        for device in ("cuda", "cpu"):
            root = AsyncSGDServer(list(named.items()), lr=0.05,
                                  momentum=0.9, quota=1, code=code,
                                  device=device)
            root.compile_step(mlp_loss_fn)
            t, box = _serve_thread(root, updates)
            hier = Hierarchy(list(named.items()), groups=1, group_size=1,
                             upstream=[("127.0.0.1", root.address[1])],
                             code=code, device=device)
            try:
                hier.compile()
                _lockstep_links(hier.aggregators[0]._upstream)
                torch.cuda.synchronize()
                reset_launch_counts()
                ht, hbox = _hier_thread(hier)
                worker = AsyncPSWorker("127.0.0.1", hier.addresses[0][1],
                                       code=code, device=device,
                                       reconnect_retries=1)
                worker._lockstep = True
                worker.run(mlp_loss_fn, dataset_batch_fn(x, y, 64, seed=2))
                hist = _mh_joined(t, box, f"hierarchy MLP {code} {device}")
                ht.join(MH_TIMEOUT)
                if ht.is_alive() or "error" in hbox:
                    fail(f"hierarchy MLP {code} {device}: "
                         f"{hbox.get('error')!r}")
            finally:
                hier.close()
                root.close()
            torch.cuda.synchronize()
            counts = launch_counts()
            out[device] = (hist["losses"],
                           {n: p.cpu().numpy()
                            for n, p in root.params.items()})
            if device == "cuda" and code == "blockq":
                fills = hbox["view"]["fault_stats"]["agg_forwards"]
                expect_counts(f"hierarchy MLP {code} on the card", counts,
                              block_quantize=len(named) * (updates + fills),
                              block_dequant_sum=updates + fills)
        a, b = out["cuda"][1], out["cpu"][1]
        outside = sum(int((~np.isclose(a[n], b[n], rtol=1e-4,
                                       atol=1e-5)).sum()) for n in b)
        total = sum(v.size for v in b.values())
        print(f"[hier] 12d lockstep MLP {code}, 1 group, {updates} "
              f"updates, card vs CPU: losses {out['cuda'][0]} vs "
              f"{out['cpu'][0]}, max difference {_np_max_diff(a, b)}, "
              f"{outside} of {total} elements outside rtol 1e-4 / atol "
              f"1e-5")
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
        if outside > (0 if code == "identity" else 1e-4 * total):
            fail(f"hierarchy MLP {code} card vs CPU: {outside} elements "
                 f"apart")


def run_hier_phase(run1b):
    """Phase 12: the hierarchy on the card (12a-12d); ``run1b`` is phase
    7's run 1b (images/s, GRAD bytes an update) in this call."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ps_hier_")
    try:
        named, loss_fn, _ = _async_resnet18()
        ips = hier_resnet_run(
            f"ResNet-18 blockq, {HIER_GROUPS} aggregators of "
            f"{HIER_GROUP_SIZE} worker processes, root quota {HIER_GROUPS} "
            f"(12a)", named, loss_fn, tmp, run1b_ips=run1b[0],
            run1b_grad=run1b[1])
        killed = hier_resnet_run(
            f"12a with group 0's aggregator killed before its fill "
            f"{HIER_KILL_AT} and restarted (12b)", named, loss_fn, tmp,
            run1b_ips=run1b[0], run1b_grad=run1b[1], kill_at=HIER_KILL_AT)
        print(f"[hier] 12b: {killed:.1f} images/s against 12a's {ips:.1f} "
              f"(ratio {killed / ips:.3f}: the restart)")
        del named, loss_fn
        torch.cuda.empty_cache()
        hier_cli(tmp)
        hier_card_vs_cpu()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[hier] phase 12 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 13: the multi-rank LM paths over a named mesh
# ---------------------------------------------------------------------------

# Phase 4's bench LM step in this call (run_lm), for phase 13's ratios.
PHASE4 = {}
# Steps of each phase-13 run: warm-up (blocking) and timed (queued).
MESH_WARM, MESH_TIMED = 2, 3
# The CLI's MoE LM (phase 9's configuration).
MESH_MOE = dict(vocab_size=32768, d_model=256, n_heads=8, n_layers=4,
                d_ff=1024, max_len=2048, moe_experts=8, moe_capacity=1.25)
MOE_LEAVES = 58
# The first step's loss against the dense model's on the same weights and
# batch (bf16 throughout): relative tolerance.
MESH_LOSS_RTOL = 1e-2


def _mesh_run(what, mesh, named, loss_fn, batch, *, flash, tokens, dense,
              leaves, profile=False, **kwargs):
    """``MESH_WARM`` blocking and ``MESH_TIMED`` queued steps of
    ``SGD(lr=0.01, momentum=0.9)`` with blockq over ``mesh`` (NCCL groups
    of one rank), the launch counts zeroed just before and read just
    after; asserts ``flash`` launches of each flash kernel a step, one
    ``block_quantize`` a leaf and the grouped decode a step, finite and
    falling losses, and the first step's loss against ``dense`` (the dense
    model's on the same weights and batch); with ``profile``, then the
    device time of two more steps by kernel category.  Returns ms/step."""
    import torch

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = SGD(list(named.items()), lr=0.01, momentum=0.9, code="blockq",
              mesh=mesh, **kwargs)
    opt.compile_step(loss_fn)
    reset_launch_counts()
    losses = []
    for _ in range(MESH_WARM):
        losses.append(opt.step(batch)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED):
        losses.append(opt.step(batch, block=False)[0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in losses]
    steps = MESH_WARM + MESH_TIMED
    expect_counts(what, counts, flash_fwd=flash * steps,
                  flash_bwd_dkdv=flash * steps, flash_bwd_dq=flash * steps,
                  block_quantize=leaves * steps,
                  block_dequant_sum=ck.group_launches(
                      "block_dequant_sum", leaves) * steps)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: losses must be finite and fall: {losses}")
    check_params_finite(opt, what)
    gap = abs(losses[0] - dense)
    if gap > MESH_LOSS_RTOL * abs(dense):
        fail(f"{what}: first loss {losses[0]} against the dense model's "
             f"{dense}: {gap} apart (tolerance {MESH_LOSS_RTOL} relative)")
    ms = seconds / MESH_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[mesh] {what}: {ms:.3f} ms/step, {tokens * MESH_TIMED / seconds:.1f}"
          f" tokens/s ({MESH_TIMED} queued steps after {MESH_WARM} warm-up, "
          f"host clock to synchronize); peak memory {peak:.2f} GiB; losses "
          f"{losses}; first loss vs the dense model's {dense}: {gap:.6f} "
          f"(tolerance {MESH_LOSS_RTOL} relative); launches {counts}")
    if profile:
        profile_steps(opt, batch, what)
    del opt
    torch.cuda.empty_cache()
    return ms


def _dense_loss(model, named, batch):
    """The dense model's loss on ``named`` and ``batch``, no gradient."""
    import torch

    from pytorch_ps_mpi_tpu_torch.models import make_lm_loss

    params = {n: p.cuda() for n, p in named.items()}
    with torch.no_grad():
        loss = float(make_lm_loss(model)(params, batch))
    del params
    return loss


def _mesh_small_card_vs_cpu():
    """13f: a small f32 LM (phase 4's small check: d_model 64, 4 heads, 2
    layers, S=160) at each of 13a-13e's configurations, 3 identity steps
    on the card (flash kernels, NCCL groups) and on the CPU (plain
    versions, gloo groups), from the same weights and tokens; phase 4's
    tolerance, rtol=1e-4 and atol=1e-5."""
    import functools

    from pytorch_ps_mpi_tpu_torch import SGD, flash_attention
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_lm
    from pytorch_ps_mpi_tpu_torch.models import (TransformerLM, build_lm,
                                                 lm_batch, make_lm_loss)
    from pytorch_ps_mpi_tpu_torch.models.pipelined import (
        make_pipelined_lm_loss)
    from pytorch_ps_mpi_tpu_torch.parallel import mesh as M
    from pytorch_ps_mpi_tpu_torch.parallel.ring_attention import (
        ring_attention)
    from pytorch_ps_mpi_tpu_torch.parallel.ulysses import ulysses_attention

    cfg = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_len=256)
    flash = functools.partial(flash_attention, causal=True)
    batch = lm_batch(synthetic_lm(4, seq_len=160, vocab=97, seed=4))
    configs = {
        "tp": ("make_dp_tp_mesh", dict(attn=flash, tp_axis="tp"), {}, None),
        "sp ulysses": ("make_dp_sp_mesh", dict(attn=functools.partial(
            ulysses_attention, axis="sp", causal=True,
            inner=flash_attention)), dict(batch_spec=("ps", "sp")), None),
        "sp ring": ("make_dp_sp_mesh", dict(attn=functools.partial(
            ring_attention, axis="sp", causal=True)),
            dict(batch_spec=("ps", "sp")), None),
        "pp": ("make_dp_pp_mesh", dict(attn=flash), {}, 2),
        "ep": ("make_dp_ep_mesh", dict(attn=flash, moe_experts=4,
                                       ep_axis="ep"),
               dict(axis=("ps", "ep"), batch_spec=(("ps", "ep"),)), None),
    }
    for what, (make, model_kw, kw, micro) in configs.items():
        model = TransformerLM(**cfg, **model_kw)
        named = build_lm(model, seed=3)
        out = {}
        for device in ("cuda", "cpu"):
            mesh = getattr(M, make)(1, 1, device=device)
            opt = SGD(list(named.items()), lr=0.05, momentum=0.9,
                      mesh=mesh, **kw)
            opt.compile_step(make_pipelined_lm_loss(model, n_micro=micro)
                             if micro else make_lm_loss(model))
            out[device] = ([opt.step(batch)[0] for _ in range(3)],
                           {n: p.cpu().numpy()
                            for n, p in opt.params.items()})
        _assert_close_runs(f"13f small LM {what} (mesh 1 x 1)", out, 1e-4,
                           1e-5)


def run_mesh_phase(group):
    """Phase 13: the bench LM over each multi-rank path on meshes of one
    rank an axis (13a tp, 13b sp with Ulysses over the flash kernels, 13c
    sp with the ring, 13d pp with 4 microbatches), the CLI's MoE LM at ep
    (13e), a plain blockq step of the bench LM for reference, and the
    small f32 LM card against CPU at each configuration (13f)."""
    import functools

    import torch

    from pytorch_ps_mpi_tpu_torch import SGD, flash_attention
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_lm
    from pytorch_ps_mpi_tpu_torch.models import (TransformerLM, build_lm,
                                                 lm_batch, make_lm_loss)
    from pytorch_ps_mpi_tpu_torch.models.pipelined import (
        make_pipelined_lm_loss)
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.parallel import mesh as M
    from pytorch_ps_mpi_tpu_torch.parallel.ring_attention import (
        ring_attention)
    from pytorch_ps_mpi_tpu_torch.parallel.ulysses import ulysses_attention

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    flash = functools.partial(flash_attention, causal=True)
    dense = TransformerLM(**LM, dtype=torch.bfloat16, attn=flash)
    named = build_lm(dense, seed=0)
    toks = synthetic_lm(LM_BATCH, seq_len=LM_SEQ, vocab=LM["vocab_size"],
                        seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in lm_batch(toks).items()}
    tokens = LM_BATCH * LM_SEQ
    layers = LM["n_layers"]
    dense_loss = _dense_loss(dense, named, batch)

    # The plain step, blockq, without a mesh (the group of phase 3).
    torch.cuda.reset_peak_memory_stats()
    opt = SGD(list(named.items()), lr=0.01, momentum=0.9, code="blockq",
              device="cuda", group=group)
    opt.compile_step(make_lm_loss(dense))
    reset_launch_counts()
    for _ in range(MESH_WARM):
        opt.step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED):
        opt.step(batch, block=False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / MESH_TIMED * 1e3
    counts = launch_counts()
    expect_counts("13 plain blockq", counts,
                  flash_fwd=layers * (MESH_WARM + MESH_TIMED),
                  flash_bwd_dkdv=layers * (MESH_WARM + MESH_TIMED),
                  flash_bwd_dq=layers * (MESH_WARM + MESH_TIMED),
                  block_quantize=LM_TENSORS * (MESH_WARM + MESH_TIMED),
                  block_dequant_sum=ck.group_launches(
                      "block_dequant_sum", LM_TENSORS)
                  * (MESH_WARM + MESH_TIMED))
    del opt
    phase4 = PHASE4.get("ms")
    print(f"[mesh] 13 plain bench LM step, blockq, no mesh: {plain_ms:.3f} "
          f"ms/step, {tokens * MESH_TIMED / (plain_ms * MESH_TIMED / 1e3):.1f}"
          f" tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase 4's "
          f"identity step in this call: "
          + (f"{phase4:.3f} ms/step" if phase4 else "not run"))
    results = {}

    def report(key, ms):
        results[key] = ms
        print(f"[mesh] {key}: {ms:.3f} ms/step against the plain blockq "
              f"step's {plain_ms:.3f} (ratio {ms / plain_ms:.3f})"
              + (f" and phase 4's identity step {phase4:.3f} (ratio "
                 f"{ms / phase4:.3f})" if phase4 else ""))

    common = dict(tokens=tokens, dense=dense_loss, leaves=LM_TENSORS)
    report("13a tp", _mesh_run(
        "13a tp (bench LM, mesh ps=1 x tp=1)", M.make_dp_tp_mesh(1, 1),
        named, make_lm_loss(dense.copy(tp_axis="tp")), batch, flash=layers,
        profile=True, **common))
    report("13b sp ulysses", _mesh_run(
        "13b sp, Ulysses over the flash kernels (bench LM, mesh ps=1 x "
        "sp=1)", M.make_dp_sp_mesh(1, 1), named,
        make_lm_loss(dense.copy(attn=functools.partial(
            ulysses_attention, axis="sp", causal=True,
            inner=flash_attention))), batch, flash=layers,
        batch_spec=("ps", "sp"), **common))
    # The ring keeps its [B, H, S, S] f32 scores for each layer's backward:
    # a peak of 41.56 GiB at batch 16 on an NVIDIA H100 80GB HBM3 (700 W),
    # so the batch is not cut.
    report("13c sp ring", _mesh_run(
        "13c sp, ring (bench LM, mesh ps=1 x sp=1)",
        M.make_dp_sp_mesh(1, 1), named,
        make_lm_loss(dense.copy(attn=functools.partial(
            ring_attention, axis="sp", causal=True))), batch, flash=0,
        batch_spec=("ps", "sp"), profile=True, **common))
    report("13d pp", _mesh_run(
        "13d pp, 4 microbatches (bench LM, mesh ps=1 x pp=1)",
        M.make_dp_pp_mesh(1, 1), named,
        make_pipelined_lm_loss(dense, n_micro=4), batch, flash=4 * layers,
        profile=True, **common))
    del named
    torch.cuda.empty_cache()

    moe = TransformerLM(**MESH_MOE, dtype=torch.bfloat16, attn=flash)
    moe_named = build_lm(moe, seed=0)
    if len(moe_named) != MOE_LEAVES:
        fail(f"the MoE LM has {len(moe_named)} leaves, expected "
             f"{MOE_LEAVES}")
    moe_ms = _mesh_run(
        "13e ep (the CLI's MoE LM, 8 experts, mesh ps=1 x ep=1)",
        M.make_dp_ep_mesh(1, 1), moe_named,
        make_lm_loss(moe.copy(ep_axis="ep")), batch, flash=4,
        axis=("ps", "ep"), batch_spec=(("ps", "ep"),), tokens=tokens,
        dense=_dense_loss(moe, moe_named, batch), leaves=MOE_LEAVES)
    print(f"[mesh] 13e ep: {moe_ms:.3f} ms/step (the MoE LM: no plain "
          f"bench LM step to compare)")
    del moe_named
    torch.cuda.empty_cache()
    _mesh_small_card_vs_cpu()
    print(f"[mesh] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return results


# ---------------------------------------------------------------------------
# topk's selection on tied magnitudes: the card against the CPU
# ---------------------------------------------------------------------------


def check_topk_ties():
    """The topk codec selects what ``lax.top_k`` does — magnitudes
    descending, the lower index first among ties — on the card as on the
    CPU: bf16 leaves (many equal magnitudes) of 2,000 elements and of the
    largest ResNet-18 gradient's 2,359,296, at 1%, indices and values
    equal."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops.codecs import TopKCodec

    g = torch.Generator().manual_seed(0)
    codec = TopKCodec(fraction=0.01)
    for n in (2000, 2359296):
        leaf = (torch.randn(n, generator=g) * 0.01).to(torch.bfloat16)
        cpu, card = codec.encode(leaf), codec.encode(leaf.cuda())
        kth = leaf.abs()[cpu["indices"].long()].float().min()
        ties = int((leaf.abs().float() == kth).sum())
        if not (torch.equal(cpu["indices"], card["indices"].cpu())
                and torch.equal(cpu["values"], card["values"].cpu())):
            fail(f"topk on a tied bf16 leaf of {n}: the card selects other "
                 f"indices than the CPU")
        print(f"[topk] bf16 leaf of {n}, k {cpu['indices'].numel()}: "
              f"{ties} elements tie at the k-th magnitude; the card's "
              f"indices and values equal the CPU's")


# ---------------------------------------------------------------------------
# The reference's nonblocking collectives, at NCCL world 1
# ---------------------------------------------------------------------------


def check_nonblocking_collectives(group):
    """Each of `parallel.collectives`' ``i*`` ops once on the card over
    the phase's one-rank NCCL group, against its definition at world 1,
    with the JAX package's timing keys."""
    import torch

    from pytorch_ps_mpi_tpu_torch.parallel import collectives as C

    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(3, 5, device="cuda", generator=g),
            "q": torch.arange(7, dtype=torch.int16, device="cuda")}
    stacked = {k: v[None] for k, v in tree.items()}
    cases = [("iallgather", C.iallgather(tree, group), stacked),
             ("iallgather", C.igather(tree, group), stacked),
             ("igather", C.igather(tree, group, root=0, root_only=True),
              stacked),
             ("ibroadcast", C.ibroadcast(tree, group, root=0), tree),
             ("ialltoall", C.ialltoall({"a": stacked["w"]}, group),
              {"a": stacked["w"]}),
             # NCCL sums no int16: the f32 leaf alone.
             ("ireduce", C.ireduce({"w": tree["w"]}, group),
              {"w": tree["w"]})]
    for name, pending, want in cases:
        got = pending.wait()
        keys = sorted(pending.timings)
        if keys != sorted(["msg_bytes", f"{name}_time", "comm_wait"]):
            fail(f"{name}: timings {keys}")
        for k in want:
            if not (got[k].is_cuda and torch.equal(got[k], want[k])):
                fail(f"{name}: {k} differs from its definition")
    print(f"[coll] iallgather, igather (all and root only), ibroadcast, "
          f"ialltoall and ireduce at NCCL world 1 on the card: results "
          f"equal their definitions; timings keys msg_bytes, <op>_time, "
          f"comm_wait (comm_wait of the last {pending.timings['comm_wait'] * 1e3:.3f} ms)")


def run_cli(phase3_images_per_s, n_leaves):
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ps_cli_")
    try:
        cli_resnet18(phase3_images_per_s, n_leaves)
        cli_resnet50()
        cli_lenet_bf16()
        cli_lm()
        cli_preempt_and_resume(tmp)
        cli_guard_rollback(tmp)
        cli_card_vs_cpu(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[cli] phase 5 took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the "
              "port on the card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import torch.distributed as dist

    from pytorch_ps_mpi_tpu_torch import make_ps_group
    from pytorch_ps_mpi_tpu_torch.ops import _build

    # --- 1. environment ---
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    card = card_line()
    print(f"[env] {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[env] TF32 off: torch.backends.cudnn.allow_tf32=False, "
          "torch.backends.cuda.matmul.allow_tf32=False (the models' "
          "convolutions and matmuls run in bf16; the f32 heads, among them "
          "the LM's lm_head, the plain versions and the small reference "
          "checks run in full f32)")
    t0 = time.perf_counter()
    built = _build.build()  # one nvcc per source, run together
    for name in built:
        _build.library(name)
    print(f"[env] built {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "smem")):
                print(f"[env] nvcc {name}: {line.strip()}")
    # The host library of the CLI's checkpoints and loader (g++): built
    # here, so that no run of phase 5 pays for its build.
    from pytorch_ps_mpi_tpu_torch import native

    t0 = time.perf_counter()
    native.lib()
    print(f"[env] built the native host library (g++: the serializer and "
          f"the loader's row gather) in {time.perf_counter() - t0:.2f} s")

    # --- 2. kernels against their plain versions ---
    from pytorch_ps_mpi_tpu_torch.models import build_model, resnet18
    from pytorch_ps_mpi_tpu_torch.parallel.overlap import plan_overlap

    named, _ = build_model(resnet18(), seed=0)
    sizes = [p.numel() for p in named.values()]
    plan = plan_overlap(named, OVERLAP_BUCKET_BYTES, record=False)
    errs = check_kernels(sizes, [[named[n].numel() for n in b]
                                 for b in plan.buckets])
    times = time_kernels(sizes)
    print_flash_occupancy()
    errs.update(check_flash_kernels())
    times.update(time_flash_kernels())
    time_flash_serve_shape()

    # --- 3. the slice, 4. the transformer LM ---
    group = make_ps_group("cuda")
    cpu_group = dist.new_group(backend="gloo")
    launches, images_per_s = run_slice(group, cpu_group)
    launches.update(run_lm(group, cpu_group))

    check_nonblocking_collectives(group)
    check_topk_ties()

    # --- 5. the training CLI, 6. the async PS, 7. the multihost PS ---
    run_cli(images_per_s, len(named))
    threads_ips = run_async_phase()
    run1a_ips, run1b = run_multihost_phase(threads_ips)

    # --- 8. the bucket stream, 9. the MoE LM, 10. the serve tier ---
    run_bucket_phase(run1a_ips)
    run_moe_phase()
    run_serve_phase()

    # --- 11. the sharded fleet, 12. the hierarchy ---
    run_fleet_phase(run1a_ips)
    run_hier_phase(run1b)

    # --- 13. the multi-rank LM paths over a named mesh ---
    run_mesh_phase(group)

    # --- 14. results ---
    kernels = []
    for k, replaces in {**REPLACES, **FLASH_REPLACES}.items():
        kernels.append({
            "name": k, "route": "cuda",
            "source": SOURCE if k in REPLACES else FLASH_SOURCE,
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": errs[k], "ms": times[k]["ms"],
            "plain_ms": times[k]["plain_ms"],
            "bound_ms": times[k]["bound_ms"],
            "bound_by": times[k].get("bound_by", "bytes"),
            "library_ms": times[k]["library_ms"]})
    dist.destroy_process_group()
    print(f"[env] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          f"on {torch.cuda.get_device_name(0)}, the kernels' build included")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mh-worker":
        sys.exit(mh_worker_main(sys.argv[2]))
    sys.exit(main())
