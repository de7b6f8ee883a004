#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card: the RSP
kernels' autotuning, the RSP main path, the ``torch`` partition backend,
ingest from disk, block-level estimation, learning from the blocks
(ensembles, similarity, drift monitoring and the training loader),
concurrent query serving, the multi-host mesh (distributed queries and the
collective partition), dense LM serving, zamba2 hybrid serving, rwkv6
scoring, loss and serving, MoE serving (granite-moe-3b-a800m,
qwen3-moe-30b-a3b), and training (llama3.2-1b and the hubert-xlarge
encoder, through the flash backward kernel).

    python3 chip_smoke.py [--seed S] [--records N] [--out DIR]

Phases, one line each with its seconds, run in the order 1, 2, 2b, 3, 4,
3g, 3b (started), 7, 8, 10, 10b, 3b (waited for), 3c-3f, 6, 9, 5:

1. build     -- compile the nine CUDA sources (``src/repro_torch/csrc``) with
                nvcc for sm_90a, one process per source, at first use, into
                ``build/``, and print the registers, spills and shared
                memory of the kernels redesigned for Hopper (flash's
                wgmma + TMA kernel at each head dim, the shuffle's staged
                and row kernels, the SSD's ssd_state and ssd_scan, the
                WKV's wkv6_chunks, block_sketch_fused and the main path's
                plan_sketch_fused), and of the flash backward's
                fa_bwd_dkdv_wgmma and fa_bwd_dq_wgmma at D = 64, 80, 112
                and 128 and the scans' backward kernels (ssd_bwd_state,
                ssd_bwd_tile, wkv6_bwd_state, wkv6_bwd_chunk), from the
                ``-Xptxas -v`` log;
2. parity    -- each kernel against its plain PyTorch version on the card, at
                the paths' shapes: rsp_shuffle bit for bit, block_sketch
                and plan_sketch stats within 1e-5 relative, histograms
                and nsel equal (plan cases: predicate, projection, G=2,
                empty selection, labels out of range, ragged row count,
                and both read paths); 20 calls of block_sketch and of
                queries (b)'s and (c)'s plans on one block give the same
                bits, and so does a copy of the block that is not 16-byte
                aligned (the scalar load path);
                flash_attention within 2e-2 in bf16 and 2e-5 in float32
                (the reference's own tolerances) at llama3.2-1b's prefill
                shape in the serve path's strided layout, qwen2-0.5b's,
                qwen3-14b's and granite-20b's heads, a ragged S, a
                non-causal case, zamba2-7b's shared block (D = 112) and
                hubert-xlarge's encoder (D = 80, full);
                mamba2_ssd's y and h_final within 2e-4 (1 + |plain|) at
                zamba2-7b's prefill shape, with weak decay (dA in
                [-1e-3, 0]: the state crosses all 16 chunks), with
                dA = -30, at a ragged L from an initial state, and at
                B = 1; rwkv6_wkv's y and h_final within 2e-4 (1 + |plain|)
                at rwkv6-1.6b's prefill shape [8, 2048, 32, 64] with the
                model's decays, with weak decay (w in [0.999, 1): the
                state crosses all 128 chunks), with w = 1e-6 and a quarter
                of w = 0 (the clamped log), at a ragged T from an initial
                state and at B = 1, and one small case against the step
                recurrence; and each of flash, the SSD and the WKV once at
                a smoke config's width through ``impl="auto"``, which pads
                it to the kernel's (flash D = 16, the SSD's P = N = 16 at
                chunk 8, the WKV's C = 16), with the launch counted; the
                flash backward (dq, dk, dv) within 2e-2 (1 + |plain|) of its
                plain version (the port of the reference's custom VJP) on
                the same q, k, v, output and statistics at llama3.2-1b's
                training shape (q [8, 32, 2048, 64], k/v [8, 8, 2048, 64],
                causal, the layer's strided views) and hubert-xlarge's
                ([8, 16, 2048, 80], full, at the kernel's own D = 80), the same bits
                on a second call, the padded columns zero, two known-wrong
                controls (Dvec dropped; dK and dV in the wrong kv head)
                refused; the forward with lse equal to the one without and
                lse within 1e-5 (1 + |b|) of the plain statistics; and
                ``FlashAttention`` at D = 80 against the plain Function;
                the SSD and WKV backward kernels against their plain
                versions at zamba2-7b's and rwkv6-1.6b's training shapes
                and at weak and strong decays: a position's gradient
                (dxbar; dr, dk, dv) within 2e-4 (1 + |plain|), a gradient
                summed over the sequence or the heads (ddA, dB, dC; dlogw,
                du) within 1e-4 relative L2, the same bits on a second call;
2b. autotune -- into a fresh cache file in a temporary directory
                (``REPRO_AUTOTUNE_CACHE``, which the mesh's children read;
                ``REPRO_AUTOTUNE=on``): every configuration the tuner may
                choose for rsp_shuffle at [100, R, 29] and tile R / 100
                (the staged and row kernels at each CTA size) and at [4, N /
                4, 29] and tile N / 16 (phase 3f's cuda partition), block_sketch
                on a [N / 100, 29] block at 128 bins and 0 and on its 28
                features at 0 (thread budget, histogram place, rows a CTA)
                and plan_sketch for query (b)'s plan at 0 bins and query
                (c)'s at 0 and 128 (read path, thread budget, staged tile,
                histogram place) held against the plain version (the
                shuffle bit for bit, moments within 1e-5, counts, nsel and
                histograms equal), then measured (CUDA events around 20
                back-to-back calls on copies of the input that rotate past
                the L2, after a warm call; 3 rounds in turns, each
                candidate's best kept; the default stays unless beaten by
                more than the spread of the runs): each candidate's
                microseconds and spread and the winner printed, no
                candidate a plain version, none excluded.  These are every key the later phases meet: the
                main path, the ingest, estimator and learning phases, the
                serve phase and the mesh phase (its threads here, its
                processes in their own report) must record no new tuner
                measurement, so no tuning time lands in a query;
3. main path -- a class-sorted HIGGS-shaped corpus (N x 29 float32, label in
                the last column) partitioned into K blocks on the card by the
                ``cuda`` backend (checked bit for bit against the plain
                gather), summarized, saved, reopened, and queried three ways
                (unfiltered mean+p95: block_sketch; ``where=``/``columns=``
                mean: plan_sketch; per-class mean: plan_sketch with G=2),
                with every kernel's launch count read after the run;
4. agreement -- the same queries with ``sketch_impl="torch"``: the same
                blocks read, estimates and CI ends within 1e-5; every mean CI
                covers the full-scan answer computed on the card; then one
                run of each query under ``torch.profiler`` gives the device's
                busy and idle share, and one under ``cProfile`` the host
                functions that take the caller's time;
3g. torch    -- the same corpus partitioned by the ``torch`` backend on
                the card (K = 100; no kernel): its seconds beside the
                ``cuda`` backend's, Definition 2 on the card (the blocks'
                rows and the corpus's sorted by a hash of their bits, equal
                bit for bit), and a tenth of the corpus partitioned on the
                card and on the CPU, equal bit for bit;
3b. ingest   -- the same corpus written to a ``.npy`` file (1.276 GB at
                full size) and ingested from disk by ``rsp.from_source(path,
                out=...)`` (the ``np_stream`` host scatter, default chunks,
                4 workers) in a child process, started here and waited
                for after phases 7, 8 and 10 (which need no ingested store
                and are card-bound) have run beside it, which reports its seconds,
                rows a second and the peak growth of its heap (``VmData``:
                it must stay under INGEST_HEAP_BYTES, less than the corpus)
                and of its resident memory (mapped files included); every
                block equal
                to ``two_stage_partition_np`` bit for bit, the folded
                sketches equal to the np backend's summaries (mean to 1e-9,
                M2 to 1e-7, extrema and labels exact), and query (b) on the
                reopened store equal to query (b) on the np partition held
                on the card;
3c. estimator -- ``ds.estimator()`` over all blocks of the ingested store,
                one block_sketch launch a block (moments only), within 1e-5
                of the same estimator through the plain version, and
                ``ds.estimate`` of a plain torch mean over 20 blocks within
                1e-5 of the estimator of the same 20;
3d. learning  -- on the same store: (a) Algorithm 2, ``ds.ensemble`` of
                logistic regressions (g = 5, seed 7) evaluated on 200,000
                fresh records of the corpus's distribution (drawn with
                seed + 1, ``heldout_higgs_like``), its first
                batch's 5 models equal to the CPU port's from the same
                weights (rtol 2e-3, atol 2e-4), ``predict_proba`` equal to
                the CPU's (1e-5), and Fig. 6's ``ensemble_vs_single_model``
                over all 100 blocks (ensemble within 0.01 of one model
                trained on every record), plus the MLP learner over 2
                batches; (b) Sec. 7: ``ds.similarity`` of every block by
                MMD^2, KS (on the feature whose class means differ most)
                and label divergence, each below the corpus's first
                sequential chunk's (the reference's thresholds), Hotelling's
                p above 0.001 for block 0 and below 1e-6 for the chunk, and 3
                blocks equal to the CPU port's; (c) Sec. 10: a DriftMonitor
                on 5 sampled blocks (5 block_sketch launches and nothing
                else), no other block flagged, a shifted, a zeroed-column
                and a t(1.5) block all flagged, every report equal to a CPU
                monitor's; (d) ``ds.loader(8192)``: 40 batches equal to a CPU
                loader's bit for bit, a resume after batch 20, one timed
                epoch, one checked epoch (no record twice, column sums equal
                to the corpus's less the dropped tail) and the device's
                idle share of 100 profiled batches;
3e. serve     -- ``ds.serve(workers=8, seed=11)`` on the ingested store
                reopened cold: 32 tenants from 4 threads (8 each of a
                sketch answer, a p95 of column 0 over 20 blocks, query (b)
                and query (c)); every answer equal to its solo run with
                ``derive_seed(11, ticket.id)`` bit for bit, per-query
                ``CallerStats`` summing to the executor's window, and
                block_sketch and plan_sketch launched once for every block
                the progressive queries folded; then a saturation wave
                (capacity 5, queue 2, 16 submissions: rejects counted and
                every submission accounted for), a deadline wave (p95 over
                up to 100 blocks in 50 ms: every ticket ``deadline`` or
                ``converged`` with an anytime result) and one profiled wave
                of PROFILED_TENANTS tenants (two of each type) for the
                device's idle share; QPS, latency p50 and p99 by
                query type, blocks a query and the cache hit rate printed;
3f. mesh      -- on the same store and ``.npy``: query (b), query (c) and a
                p95 of column 0 over 20 blocks, (a) by four
                ``LocalTransport`` hosts on threads, each ``ds.distribute(t)``
                with 25 owned blocks: every host's answer equal to the
                single host's bit for bit, the sketch launches equal to the
                blocks the hosts read, a read outside a host's blocks an
                error (``ScopedFetcher``); (b) the same with host 3 killed
                at its third publish (grace 2 s): the survivors' answers
                equal and their ownership re-dealt to hosts 0-2; (c) four
                child processes on the card over a ``TCPStore`` this
                process hosts (``init_from_env()``), then three with the
                last SIGKILLed once it connected, every survivor's answers
                equal to the single host's; (d) ``distributed_rsp_partition``
                by four gloo ranks on the card, rank i mapping rows [i*N/4,
                (i+1)*N/4) of the ``.npy``: one rsp_shuffle launch a rank,
                the exchange through host memory, every rank's sha256 equal
                to that of block k of the ``cuda`` backend's partition with
                P = K = 4, those blocks equal to the plain gather's on the
                card, and each rank's shuffle equal to its plain gather.
                Each query's mesh time beside its single-host time, the
                payload bytes a block, the killed runs' steal times (the
                wait up to the re-deal, from telemetry in the run itself)
                and the partition's parts are printed; every child has a
                timeout;
5. times     -- (run last) each kernel's time per call with CUDA events around a run
                of back-to-back calls (the wrapper as the query path calls
                it -- for the sketches the launchers that return the packed
                output -- so host work that outlasts the kernel shows) beside its
                plain version, its bound and (for the shuffle)
                ``index_select``; and ``device_ms``, the kernels' own device
                time per call from ``torch.profiler``'s events of them, with
                the count of launches it saw (a wrapper's device kernels
                are named by its package's ``KERNELS``; a sketch call must
                launch nothing else: no memset, no cast, no second
                kernel).  plan_sketch is timed on
                query (c)'s grouped plan, which carries most of its main-path
                launches, and on query (b)'s plan on a line of its own; a
                plan's bound reads only the 32-byte sectors of the columns
                it touches; the three RSP kernels also at the tuner's
                winning configuration (``tuned_ms``, ``tuned_config``; the
                default and the winner timed in turns, ABBA, after a
                discarded warm window of each, each side's best window);
                flash at hubert-xlarge's encoder shape (D = 80); the
                flash backward at both training shapes beside its bound
                (2.5x the forward's products), its plain version and the
                backward of ``scaled_dot_product_attention`` on
                head-expanded K/V; the SSD and WKV backwards at their
                training shapes beside their bounds (``ssd_bwd_work``,
                ``wkv_bwd_work``) and plain versions (no single PyTorch
                call computes either).  Every timed loop follows a
                discarded warm window;
6. serving   -- llama3.2-1b at full width (16 layers, d_model 2048, 32 over
                8 heads, vocab 128,256; random weights from the seed):
                ``Server.generate`` of 8 prompts of 2048 tokens, 64 new
                tokens, greedy (16 flash launches: one prefill per layer),
                checked by teacher forcing the generated sequence through
                the same model with the plain attention on the card (the
                served logits, and every position's logits through the
                kernel), and the same check run on two served runs with a
                known-wrong attention (non-causal, zero output) must
                refuse both; then
                ``EnsembleServer`` over 3 models of their own seeds, 4
                prompts of 512 tokens, 32 new tokens (48 flash launches),
                whose tokens must equal the argmax of the three models'
                log-probabilities averaged outside the server.  Prefill
                seconds, time to first token, decode tokens/s, peak device
                memory and the device's idle share of one profiled
                generate of PROFILE_NEW new tokens (``torch.profiler``) are
                printed beside the card; the flash
                kernel is timed at the prefill shape beside its bound, its
                plain version and ``scaled_dot_product_attention``;
7. hybrid    -- zamba2-7b at full width and depth (81 Mamba2 layers, 14
                invocations of the shared block, d_model 3584, vocab
                32,000; random weights from the seed), beside the ingest
                child: ``Server.generate`` of 8 prompts of 2048
                tokens, 32 new tokens, greedy (81 mamba2_ssd and 14 flash
                launches), checked by teacher forcing through the plain
                SSD and the plain attention, and layer by layer (each
                block's attention or mixer output and SSM state from the
                same input through the kernels and the plain versions);
                the same checks run on two served runs with a known-wrong
                SSD (state not carried across chunks, h_final zeroed) must
                refuse both, which the layer-by-layer part does; its
                numbers as for llama; the SSD kernel and flash at D = 112
                are timed at their serving shapes;
8. rwkv      -- rwkv6-1.6b at full width and depth (24 layers, d_model
                2048, 32 heads of 64, d_ff 7168, vocab 65,536; random
                weights from the seed), after the zamba2 model is freed:
                (a) scoring: ``make_forward_fn`` on 8 x 2048 tokens (every
                position's logits) and ``make_loss_fn`` on 8 x 2049, 24
                rwkv6_wkv launches each, held against the same calls
                through the plain WKV (logits as the hybrid's sequence
                share, the loss path's cross entropy at each of the
                16,384 positions within NLL_TOL) and layer by layer
                (each layer fed the plain pass's input: the time mix's
                output within 2e-2 (1 + |b|), the WKV's y and state within
                2e-4 (1 + |b|), none beyond), beside the plain forward at
                chunk 8 against 16; (b) serving: ``Server.generate`` of 8
                prompts of 2048 tokens, 32 new tokens, greedy (24 launches
                in the prefill, none in decode), teacher-forced through
                the plain WKV from a fresh float32 state, the states after
                the prompt compared, and the served prefill layer by
                layer; (c) the same checks on two known-wrong kernels
                (state not carried across chunks, bonus u dropped) must
                refuse both, and name the parts that refuse; (d) the
                numbers as for llama, the forward's and the loss's seconds,
                and the WKV kernel timed at the prefill shape;
9. moe       -- granite-moe-3b-a800m at full width and depth (32 layers,
                d_model 1536, 40 experts top-8, 24 over 8 heads of 64,
                vocab 49,155; random weights from the seed):
                ``Server.generate`` of 8 prompts of 2048 tokens, 64 new
                (32 flash launches, the MoE layers dropless, no other
                kernel), teacher forced through cached passes (dropless, as
                served) with the plain attention and with the kernel, the
                served run's expert choices replayed in both (top-k is
                discontinuous: a one-ulp change of a router input swaps
                experts); the two known-wrong attentions must be refused;
                then qwen3-moe-30b-a3b at full width and 8 of its 48
                layers (the 48 layers' 122 GB of float32 weights exceed
                the card; head dim 128, 128 experts top-8) serving 8
                prompts of 1024 tokens, 16 new, with the same check.  Each
                model's parameters, weight GB, prefill seconds, first
                token and decode tokens/s printed beside the card;
10. training -- (after 8) llama3.2-1b as ``launch/train.py --preset full``
                builds it (16 layers, d_model 2048, remat) trained by the
                ``Trainer`` 20 steps of 8 x 2048 tokens of the Zipf token
                corpus in 16 RSP blocks (AdamW, lr 3e-4, warmup 2): 32
                forward and 16 backward flash launches a step, the loss
                falling by 1 nat or more; its step seconds (synchronised),
                tokens/s, share of the bf16 peak and peak memory printed
                beside the card; one step of the trained state under the
                flat-head layout and a 16-chunk cross entropy
                (``launch/dryrun.py``'s training overrides) against the
                grouped step: loss within 1e-2, peak memory lower;
                hubert-xlarge at full width and depth (48 layers, d_model
                1280, 16 heads of 80): ``make_forward_fn`` on 8 x 2048 x
                1280 frames against the plain attention's (48 launches, no
                logit beyond 8e-2 (1 + |b|)), then 20 training steps on
                frames that embed RSP-sampled targets (a seeded table plus
                noise, 30% masked): 96 forward and 48 backward launches a
                step, the loss falling by 1 nat or more; one profiled
                forward and backward of each model, whose device events
                must hold each of the backward's kernels once a layer; the
                restart gate:
                llama3.2-1b at full width and 2 layers, 4 steps unbroken
                against 2, a checkpoint, a fresh Trainer and 2 more, under
                ``torch.use_deterministic_algorithms``: master weights,
                moments and step equal bit for bit (the bytes written and
                the free disk printed).
10b. families -- (after 10) rwkv6-1.6b (full), zamba2-7b (full width, 24
                of its 81 layers: four rounds of the shared block and 6
                Mamba2 layers) and granite-moe-3b-a800m (full) each
                trained by the ``Trainer`` 10 steps of 8 x 2048 on the
                corpus without drift (AdamW lr 3e-4, warmup 5): losses and
                gradient norms finite, the mean of the last three losses
                below the first, the scans' and flash's launches twice a
                layer forward and once backward; one profiled forward and
                backward whose device events hold the backward's kernels
                once a layer (zamba2's flash once a shared-block call);
                first, one step of a fresh state cut to the fewest layers
                holding every kernel with the kernels against the plain
                versions, each gradient leaf within 3e-2 relative L2.

Phase 3 also times one block's partition-time summary by stage (copy off
the card, float64 moments, each host sketch).  Each path's launch counts
are set to 0 just before the path is driven and read just after (the main
path, the estimator, the drift monitor, the first serve wave, each mesh
run on threads, each rank of the collective partition, each LM path, each
MoE generate, each training run and step).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.  The
script needs one CUDA card and the repository's ``src/`` beside it; without
either it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 on the tensor cores
BLOCKS = 100                  # K = P, the paper's HIGGS setting
QUERY_RUNS = 3                # query latency is the median of these
REPS = 20                     # timed launches per kernel
MOMENT_RTOL = 1e-5
COVERAGE_CONFIDENCE = 0.999999
BINS = 128


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, t0: float, extra: str = "") -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s{(' ' + extra) if extra else ''}",
          flush=True)


def rel_err(a, b) -> float:
    """Largest |a - b| / max(|b|, 1) over finite entries; infinities must match."""
    import torch

    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    fin = torch.isfinite(b)
    check(bool(torch.equal(torch.isfinite(a), fin)), "finite entries differ")
    check(bool(torch.equal(a[~fin], b[~fin])), "infinite entries differ")
    if not bool(fin.any()):
        return 0.0
    d = (a[fin] - b[fin]).abs() / b[fin].abs().clamp(min=1.0)
    return float(d.max())


def max_abs(a, b) -> float:
    import torch

    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def _window(fn, reps: int) -> float:
    """Milliseconds per call of ``reps`` back-to-back calls of ``fn(i)``
    between two CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def time_cuda(fn, *, reps: int, windows: int = 3) -> float:
    """Milliseconds per call of ``fn(i)``: CUDA events around ``reps``
    back-to-back calls (i = 0 .. reps-1), divided by ``reps``; the median
    over ``windows`` such windows, after one warm-up call and one discarded
    window (the first window of a launch read up to 45% slow: the card
    coming up to its clocks)."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    _window(fn, reps)
    return statistics.median(_window(fn, reps) for _ in range(windows))


def time_turns(fns: dict, *, reps: int, rounds: int = 3) -> dict:
    """``time_cuda`` for several launches of one kernel at once, so that no
    side carries the order effect: a warm-up call and a discarded window of
    each, then ``rounds`` windows of each taken in turns, ABBA..., and each
    side's best window."""
    import torch

    for fn in fns.values():
        fn(0)
        torch.cuda.synchronize()
        _window(fn, reps)
    best = dict.fromkeys(fns, float("inf"))
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            best[name] = min(best[name], _window(fns[name], reps))
    return best


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sector_bytes(n: int, f: int, cols) -> int:
    """Bytes of the 32-byte memory sectors that hold columns ``cols`` of an
    ``[n, f]`` float32 row-major block: what a pass that needs only those
    columns must read."""
    import numpy as np

    cols = np.unique(np.asarray(cols, np.int64))
    addr = (np.arange(n, dtype=np.int64)[:, None] * f + cols[None, :]) * 4
    return 32 * int(np.unique(addr // 32).size)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def make_block(n: int, seed: int, device):
    """A HIGGS-shaped [n, 29] float32 block: 28 features, label in {0, 1}."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, 29), generator=g, device=device) * 1.3 + 0.2
    x[:, 28] = (torch.rand(n, generator=g, device=device) < 0.53).float()
    return x


def grid_of(x, cols=None):
    import numpy as np

    lo = x.amin(0).double().cpu().numpy()
    hi = x.amax(0).double().cpu().numpy()
    pad = np.maximum(1e-9, 1e-9 * (hi - lo))
    lo, hi = lo - pad, hi + pad
    if cols is not None:
        lo, hi = lo[list(cols)], hi[list(cols)]
    return lo, hi


def compare_sketch(name, got, want, hist_got, hist_want, errs) -> None:
    import torch

    e = rel_err(got, want)
    check(e <= MOMENT_RTOL, f"{name}: stats differ from the plain version by {e:.3g}")
    check(bool(torch.equal(got[0::5], want[0::5])), f"{name}: counts differ")
    if hist_want is not None:
        check(bool(torch.equal(hist_got, hist_want)), f"{name}: histograms differ")
    errs.append(max_abs(got, want))


def parity(args, device) -> dict:
    import torch

    from repro_torch.kernels.block_sketch.kernel import block_sketch_cuda, block_sketch_plain
    from repro_torch.kernels.block_sketch.ops import grid_tensors
    from repro_torch.kernels.plan import PlanArrays, QueryPlan
    from repro_torch.kernels.plan.kernel import plan_sketch_cuda, plan_sketch_plain
    from repro_torch.kernels.rsp_shuffle import (
        partition_permutations, rsp_shuffle_cuda, rsp_shuffle_plain)

    P = K = BLOCKS
    R = args.records // P
    delta = R // K
    n = args.records // K
    errs = {"rsp_shuffle": [], "block_sketch": [], "plan_sketch": []}

    # rsp_shuffle: the whole corpus in one batched launch, as the cuda backend does
    x = torch.randn((P, R, 29), generator=torch.Generator(device=device).manual_seed(args.seed),
                    device=device)
    tp, ip = (torch.from_numpy(a).to(device) for a in partition_permutations(args.seed, P, K, delta))
    got = rsp_shuffle_cuda(x, tp, ip, tile_rows=delta)
    want = rsp_shuffle_plain(x, tp, ip, tile_rows=delta)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, want)), "rsp_shuffle: kernel differs from the plain gather")
    errs["rsp_shuffle"].append(float((got - want).abs().max()))
    del x, got, want, tp, ip

    # block_sketch: one RSP block, with and without the histogram
    blk = make_block(n, args.seed + 1, device)
    glo, ghi = grid_of(blk)
    lo, invw = grid_tensors(glo, ghi, BINS, device)
    for bins in (BINS, 0):
        s1, h1 = block_sketch_cuda(blk, lo, invw, bins=bins)
        s2, h2 = block_sketch_plain(blk, lo, invw, bins=bins)
        compare_sketch(f"block_sketch bins={bins}", s1, s2, h1, h2, errs["block_sketch"])
    # inv_width = 0 sends everything to bin 0
    s1, h1 = block_sketch_cuda(blk, lo, torch.zeros_like(invw), bins=BINS)
    s2, h2 = block_sketch_plain(blk, lo, torch.zeros_like(invw), bins=BINS)
    compare_sketch("block_sketch inv_width=0", s1, s2, h1, h2, errs["block_sketch"])
    check(bool((h1[:, 0] == n).all()), "block_sketch: inv_width=0 must fill bin 0")

    # plan_sketch: the cases the query layer sends
    odd = blk.clone()
    odd[:, 28] = torch.tensor([-2.0, -0.5, 0.0, 1.0, 1.5, 2.0, 3.0], device=device)[
        torch.arange(n, device=device) % 7]
    cases = {
        "predicate": (blk, QueryPlan(predicates="c0 > 0.5")),
        "projection": (blk, QueryPlan(columns=(0, 3, 28))),
        "grouped G=2": (blk, QueryPlan(predicates="c1 < 1.0", group_by=28, num_classes=2)),
        "empty selection": (blk, QueryPlan(predicates="c0 > 1e9")),
        "labels out of range": (odd, QueryPlan(group_by=28, num_classes=2)),
        "ragged rows": (blk[: n - 37].contiguous(),
                        QueryPlan(predicates=["c2 >= 0.1", "c5 != 0.0"], columns=(1, 2))),
    }
    cases["query (b)'s plan, gather path"] = (blk, QueryPlan(predicates="c0 > 0.5",
                                                            columns=(0, 28)))
    cases["query (c)'s plan, stage path"] = (blk, QueryPlan(group_by=28, num_classes=2))
    for name, (xb, plan) in cases.items():
        cols = plan.resolve_columns(29)
        glo, ghi = grid_of(xb, cols)
        for bins in (BINS, 0):
            lo, invw = grid_tensors(glo, ghi, BINS, device) if bins else (None, None)
            arrays = PlanArrays.build(plan, 29, device)
            s1, h1, n1 = plan_sketch_cuda(xb, arrays, lo, invw, bins=bins)
            s2, h2, n2 = plan_sketch_plain(xb, plan, lo, invw, bins=bins)
            check(torch.equal(n1, n2), f"plan {name}: nsel {n1.item()} != {n2.item()}")
            compare_sketch(f"plan {name} bins={bins}", s1, s2, h1, h2, errs["plan_sketch"])

    # the fold order is fixed and the scratch left clean: 20 calls, one set
    # of bits; a block that is not 16-byte aligned takes the scalar path to
    # the same bits
    shifted = torch.empty(blk.numel() + 1, device=device)[1:].view(blk.shape)
    shifted.copy_(blk)
    check(shifted.data_ptr() % 16 != 0, "the shifted copy is 16-byte aligned")
    glo, ghi = grid_of(blk)
    lo, invw = grid_tensors(glo, ghi, BINS, device)
    same_bits("block_sketch", lambda xb: block_sketch_cuda(xb, lo, invw, bins=BINS), blk, shifted)
    for name in ("query (b)'s plan, gather path", "query (c)'s plan, stage path"):
        plan = cases[name][1]
        arrays = PlanArrays.build(plan, 29, device)
        glo, ghi = grid_of(blk, plan.resolve_columns(29))
        lo, invw = grid_tensors(glo, ghi, BINS, device)
        same_bits(f"plan_sketch, {name}",
                  lambda xb: plan_sketch_cuda(xb, arrays, lo, invw, bins=BINS), blk, shifted)
    return {k: max(v) for k, v in errs.items()}


def same_bits(name, call, blk, shifted, reps: int = 20) -> None:
    """``reps`` calls on ``blk`` and one on its unaligned copy ``shifted``
    give bit-identical outputs."""
    import torch

    first = [t.clone() for t in call(blk) if t is not None]
    for i in range(reps):
        again = [t for t in call(blk if i < reps - 1 else shifted) if t is not None]
        check(all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                              b.view(torch.int32) if b.dtype == torch.float32 else b)
                  for a, b in zip(first, again)),
              f"{name}: call {i + 2} ({'unaligned' if i == reps - 1 else 'aligned'})"
              " differs from the first")


# ---------------------------------------------------------------------------
# Phases 3-4: the main path
# ---------------------------------------------------------------------------

def make_corpus(records: int, seed: int):
    import numpy as np

    from repro_torch.data import make_nonrandom_higgs_like

    x, y = make_nonrandom_higgs_like(records, seed=seed)
    data = np.empty((records, 29), np.float32)
    data[:, :28] = x
    data[:, 28] = y
    return data


def queries():
    from repro_torch.rsp import Aggregate

    common = dict(target_rel_err=0.01, confidence=COVERAGE_CONFIDENCE, use_sketches=False)
    return {
        "a_mean_p95": (["mean", "p95"], dict(common)),
        "b_where_columns": ("mean", dict(common, where="c0 > 0.5", columns=(0, 28))),
        "c_by_label": (Aggregate("mean", by_label=True), dict(common)),
    }


def truths(data_dev) -> dict:
    import torch

    x = data_dev.double()
    sel = data_dev[:, 0] > torch.tensor(0.5, dtype=torch.float32, device=data_dev.device)
    lab = data_dev[:, 28].to(torch.int64)
    return {
        "a_mean_p95": x.mean(0).cpu().numpy(),
        "b_where_columns": x[sel][:, [0, 28]].mean(0).cpu().numpy(),
        "c_by_label": torch.stack([x[lab == c].mean(0) for c in (0, 1)]).cpu().numpy(),
    }


def covers(agg, truth) -> bool:
    import numpy as np

    lo = np.asarray(agg.ci_lo, np.float64)
    hi = np.asarray(agg.ci_hi, np.float64)
    # the float32 rounding of per-block sketches, folded in float64
    tol = 1e-5 * np.maximum(np.abs(truth), 1.0)
    return bool(np.all(lo - tol <= truth) and np.all(truth <= hi + tol))


def agree(r1, r2) -> float:
    """Largest relative deviation between two results' estimates and CI ends."""
    worst = 0.0
    for a, b in zip(r1.aggregates, r2.aggregates):
        for f in ("estimate", "ci_lo", "ci_hi"):
            worst = max(worst, rel_err(getattr(a, f), getattr(b, f)))
    return worst


def summary_probe(block) -> dict:
    """Seconds of one block's partition-time summary, split by stage (the
    device-to-host copy, the float64 moments, then each host sketch)."""
    import os

    import numpy as np

    from repro_torch.kernels.block_sketch.ref import block_sketch_ref
    from repro_torch.rsp.sketch import SketchSuite

    out = {}
    t0 = time.perf_counter()
    x = block.cpu().numpy()
    out["copy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x64 = x.astype(np.float64).reshape(x.shape[0], -1)
    block_sketch_ref(x64)
    out["moments_s"] = time.perf_counter() - t0
    suite = SketchSuite.create(0, label_column=28, num_classes=2)
    for kind, member in suite.sketches.items():
        if kind != "moments":
            t0 = time.perf_counter()
            member.update(x64)
            out[f"{kind}_s"] = time.perf_counter() - t0
    out["host"] = {"cpus": len(os.sched_getaffinity(0)), "numpy": np.__version__}
    return out


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start us, duration us) of every device event -- kernels, fills
    and copies -- a finished ``torch.profiler`` session saw.  The raw Kineto
    events: prof.events() would parse them into a Python event tree first,
    which takes minutes for a generate's ~10^5 events."""
    from torch.autograd import DeviceType

    return [(evt.name(), evt.start_ns() / 1e3, evt.duration_ns() / 1e3)
            for evt in prof.profiler.kineto_results.events()
            if evt.device_type() == DeviceType.CUDA]


def profiled(fn, counts: dict | None = None) -> tuple[float, float | None, dict, int]:
    """Run ``fn()`` under ``torch.profiler``: (wall seconds, seconds in the
    union of the device's busy intervals -- kernels, fills and copies -- or
    None when the profiler saw no device event, device seconds by name,
    number of device events); ``counts``, when given, takes the number of
    device events by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    spans, by_name = [], {}
    for name, start, dur in events:
        spans.append((start, start + dur))
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return wall, (busy / 1e6 if spans else None), by_name, len(spans)


def device_share(ds, aggs, kw) -> dict:
    """One profiled run of a query: wall and device-busy seconds and the
    four largest device items."""
    wall, busy, by_name, _ = profiled(lambda: ds.query(aggs, **kw))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_s": wall, "busy_s": busy, "top": [(name[:60], sec) for name, sec in top]}


def host_profile(ds, aggs, kw, top: int = 10) -> dict:
    """One run of a query under ``cProfile``: wall seconds and the ``top``
    functions by own time and by cumulative time.  The per-block payloads
    and the fold run on the caller's thread; from Python 3.12 ``cProfile``
    also sees the fetch workers' threads, so where they overlap the caller
    the times of several threads add up.  Array indexing is not a call, so
    its time counts as the own time of the function that indexes."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    ds.query(aggs, **kw)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    rows = [
        (f"{Path(file).name}:{line}({fn})", tt, ct)
        for (file, line, fn), (_, _, tt, ct, _) in pstats.Stats(prof).stats.items()
    ]
    return {
        "wall_s": wall,
        "own_s": [(name, tt) for name, tt, _ in sorted(rows, key=lambda r: -r[1])[:top]],
        "cumulative_s": [(name, ct) for name, _, ct in sorted(rows, key=lambda r: -r[2])[:top]],
    }


PROFILER_WARMUP = 64   # device events launched before a device_ms window
PROFILER_SESSIONS = 3  # device_ms profiles again while launches go unseen


def device_ms(fn, reps: int, *kernels: str) -> dict:
    """The kernels' own device time per call: ``fn(i)``, i = 0 .. reps-1,
    back to back under ``torch.profiler``, and the durations of the device
    events whose names hold one of ``kernels`` (the wrapper's launches),
    summed and divided by ``reps``.  The profiler misses the device events
    of a session's first moments (on the H100: the first 11 to all of 64
    small fills, in some sessions every event), so PROFILER_WARMUP fills
    and a 50 ms pause go first, and a session that missed a launch is run
    again, up to PROFILER_SESSIONS in all.  ``seen`` counts each kernel's
    events, ``warmup_seen`` the fills' and ``others`` every other device
    event (memsets, copies, kernels not named) in the last session; ``ms``
    is None unless it saw every launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(1, dtype=torch.int16, device="cuda")    # no wrapper fills int16
    for session in range(1, PROFILER_SESSIONS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILER_WARMUP):
                scratch.fill_(0)
            torch.cuda.synchronize()
            time.sleep(0.05)
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        events = device_events(prof)
        seen = {k: sum(1 for name, _, _ in events if k in name) for k in kernels}
        if all(n == reps for n in seen.values()):
            break
    total = sum(dur for name, _, dur in events if any(k in name for k in kernels))
    warm = sum(1 for name, _, _ in events if "FillFunctor<short>" in name)
    return {"ms": total / reps / 1e3 if all(n == reps for n in seen.values()) else None,
            "seen": seen, "launched": reps, "sessions": session,
            "warmup_seen": warm, "warmup_launched": PROFILER_WARMUP,
            "others": len(events) - sum(seen.values()) - warm}


def main_path(args, device) -> dict:
    import numpy as np
    import torch

    from repro_torch import kernels, rsp
    from repro_torch.kernels.rsp_shuffle import partition_permutations, rsp_shuffle_plain

    K = BLOCKS
    t0 = time.perf_counter()
    data = make_corpus(args.records, args.seed)
    phase("corpus", t0, f"records={args.records} shape={list(data.shape)} class-sorted")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = rsp.partition(data, blocks=K, seed=args.seed, num_classes=2, summaries=False,
                       device="cuda")
    torch.cuda.synchronize()
    partition_s = time.perf_counter() - t0
    phase("partition", t0, f"backend={ds.backend} K={K} n={ds.block_size}")
    check(ds.backend == "cuda", f"auto chose backend {ds.backend!r}, expected 'cuda'")

    t0 = time.perf_counter()
    summaries = ds.summaries
    summaries_s = time.perf_counter() - t0
    div = ds.label_divergence()
    phase("summaries", t0, f"host numpy f64, {len(summaries)} blocks;"
          f" worst block label divergence {div:.3g} (sequential chunking: 0.5)")
    check(div < 0.05, f"label divergence {div} is not near 0")
    probe = summary_probe(ds.block(0))
    print(f"summaries of one block, by stage: {json.dumps(probe)}", flush=True)

    tmp = tempfile.mkdtemp(prefix="rsp_smoke_")
    try:
        t0 = time.perf_counter()
        ds.save(tmp)
        save_s = time.perf_counter() - t0
        phase("save", t0, f"{sum(p.stat().st_size for p in Path(tmp).iterdir()) / 1e9:.3f} GB")
        ds_open = rsp.open(tmp, device="cuda")
        check(len(ds_open.summaries) == K, "reopened store lost its sketches")

        results, lat = {}, {}
        for name, (aggs, kw) in queries().items():
            runs = []
            for _ in range(QUERY_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = ds_open.query(aggs, **kw)
                runs.append(time.perf_counter() - t0)
            results[name] = r
            lat[name] = runs
            fetch_s = r.trace.steps[-1].cum_fetch_s if r.trace and r.trace.steps else 0.0
            phase(f"query {name}", t0, f"p50 {statistics.median(runs) * 1e3:.1f} ms,"
                  f" blocks_read={r.blocks_read}, converged={r.converged},"
                  f" store fetch {fetch_s * 1e3:.1f} ms of the last run")
        counts = kernels.launch_counts()   # the main path ends here
        print(f"launches on the main path: {json.dumps(counts)}", flush=True)
        for k in ("rsp_shuffle", "block_sketch", "plan_sketch"):
            check(counts[k] > 0, f"kernel {k} was not launched on the main path")

        # plain-version partition on the card, bit for bit
        t0 = time.perf_counter()
        P, R, delta = ds.spec.num_original_blocks, ds.spec.original_block_size, ds.spec.slice_size
        x_dev = torch.from_numpy(data).to(device)
        tp, ip = (torch.from_numpy(a).to(device)
                  for a in partition_permutations(args.seed, P, K, delta))
        plain = rsp_shuffle_plain(x_dev.reshape(P, R, 29), tp, ip, tile_rows=delta)
        plain = plain.reshape(P, K, delta, 29).transpose(0, 1).reshape(K, P * delta, 29)
        check(bool(torch.equal(plain, ds.stacked())),
              "cuda partition differs from the plain gather")
        del plain, tp, ip
        phase("partition check", t0, "equal to the plain gather bit for bit")

        t0 = time.perf_counter()
        truth = truths(x_dev)
        worst = 0.0
        for name, (aggs, kw) in queries().items():
            r_torch = ds_open.query(aggs, **dict(kw, sketch_impl="torch"))
            r = results[name]
            check(r_torch.blocks_read == r.blocks_read,
                  f"{name}: blocks_read {r.blocks_read} (cuda) vs {r_torch.blocks_read} (torch)")
            dev = agree(r, r_torch)
            check(dev <= MOMENT_RTOL, f"{name}: cuda and torch answers differ by {dev:.3g}")
            worst = max(worst, dev)
            mean = r.aggregates[0]
            est = np.asarray(mean.estimate, np.float64)
            check(est.shape == np.shape(truth[name]) and np.all(np.isfinite(est)),
                  f"{name}: estimate shape {est.shape} or non-finite values")
            check(covers(mean, truth[name]), f"{name}: mean CI misses the full-scan answer")
        phase("agreement", t0, f"cuda vs torch max deviation {worst:.3g};"
              f" every mean CI covers the full-scan answer at {COVERAGE_CONFIDENCE}")
        del x_dev

        t0 = time.perf_counter()
        shares = {name: device_share(ds_open, aggs, kw) for name, (aggs, kw) in queries().items()}
        for name, s in shares.items():
            idle = "not measured" if s["busy_s"] is None else f"{1 - s['busy_s'] / s['wall_s']:.4f}"
            print(f"device share {name}: wall {s['wall_s']:.3f} s, busy {s['busy_s']} s,"
                  f" idle share {idle}, top {json.dumps(s['top'])}", flush=True)
        phase("device share", t0, "one profiled run of each query")

        t0 = time.perf_counter()
        hosts = {name: host_profile(ds_open, aggs, kw) for name, (aggs, kw) in queries().items()}
        for name, h in hosts.items():
            print(f"host profile {name}: {json.dumps(h)}", flush=True)
        phase("host profile", t0, "one cProfile run of each query")
        ds_open.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ds.close()
    n = ds.block_size
    e2e = {
        "partition_s": partition_s,
        "summaries_s": summaries_s,
        "save_s": save_s,
        "summary_probe": probe,
        "device_share": shares,
        "host_profile": hosts,
        "queries": {
            k: {"p50_ms": statistics.median(v) * 1e3, "runs_ms": [t * 1e3 for t in v],
                "blocks_read": results[k].blocks_read,
                "rows_per_s": results[k].blocks_read * n / statistics.median(v)}
            for k, v in lat.items()
        },
    }
    return {"counts": counts, "e2e": e2e, "data": data}


# ---------------------------------------------------------------------------
# Phase 2b: the autotuner; phase 3g: the torch partition backend
# ---------------------------------------------------------------------------

def tuner_record(kernel: str, key: str, device, gpu: str) -> dict:
    """The tuner's record of ``(kernel, key)``, printed with every
    candidate's microseconds and the winner, and checked: kernel
    configurations only, none excluded, a measured winner."""
    from repro_torch.kernels import autotune

    name = f"{kernel}|{key}|{autotune.device_key(device)}"
    rec = autotune.get_tuner().records().get(name)
    check(rec is not None, f"autotune: no record for {name}")
    winner = ",".join([rec["impl"]] + [f"{k}={v}" for k, v in rec["params"]])
    if rec["tile_rows"] is not None:
        winner = f"{rec['impl']}:{rec['tile_rows']}"
    check(rec["impl"] == "cuda" and not rec["fallback"],
          f"autotune {kernel} {key}: the winner is {winner} (fallback {rec['fallback']})")
    check(all(label.startswith("cuda") for label in rec["measured_us"]),
          f"autotune {kernel} {key}: a plain version among {list(rec['measured_us'])}")
    check(not rec["excluded"], f"autotune {kernel} {key}: excluded {rec['excluded']}")
    us = ", ".join(f"{label} {t:.3f} (spread {rec['spread_us'][label]:.3f})" for label, t in
                   sorted(rec["measured_us"].items(), key=lambda kv: kv[1]))
    print(f"autotune {kernel} {key}: winner {winner} at {rec['us']:.3f} us a call; candidates"
          f" (us a call over {autotune.CALLS} back-to-back calls on rotating copies, best of"
          f" 3 rounds): {us} [{gpu}]", flush=True)
    return {"winner": winner, "us": rec["us"], "measured_us": rec["measured_us"],
            "spread_us": rec["spread_us"]}


def autotune_phase(args, device, cache: str, gpu: str) -> dict:
    """Phase 2b: tune the three RSP kernels at the main path's shapes, into
    a fresh cache file (``REPRO_AUTOTUNE_CACHE``, which the mesh's children
    read): every candidate held against the plain version first (the
    shuffle exact, moments within 1e-5, counts and histograms exact), then
    measured, each candidate's time and the winner printed.  The keys are
    every one the later phases meet: the shuffle at [100, R, 29] and tile
    R / 100, and at [4, N / 4, 29] and tile N / 16 (phase 3f partitions the
    corpus through the cuda backend with P = K = 4); block_sketch on a block at 128 bins (queries (a) and the p95
    tenants) and at 0 (the estimator), and on its 28 features at 0 (the
    drift monitor's reference blocks); plan_sketch for
    query (b)'s plan and query (c)'s, at 0 bins as they run, and query
    (c)'s at 128 bins."""
    import os

    import torch

    from repro_torch.kernels import _cuda, autotune
    from repro_torch.kernels.block_sketch import ops as bs_ops
    from repro_torch.kernels.block_sketch.kernel import block_sketch_cuda, block_sketch_plain
    from repro_torch.kernels.plan import PlanArrays, QueryPlan
    from repro_torch.kernels.plan import ops as plan_ops
    from repro_torch.kernels.plan.kernel import plan_sketch_cuda, plan_sketch_plain
    from repro_torch.kernels.rsp_shuffle import ops as rs_ops
    from repro_torch.kernels.rsp_shuffle import rsp_shuffle_cuda, rsp_shuffle_plain

    os.environ["REPRO_AUTOTUNE"] = "on"
    os.environ["REPRO_AUTOTUNE_CACHE"] = cache
    tuner = autotune.get_tuner()
    tuner.clear()
    P = K = BLOCKS
    R = args.records // P
    delta = R // K
    n = args.records // K
    out = {"cache": cache, "records": {}}
    errs = []

    t0 = time.perf_counter()
    x = torch.randn((P, R, 29), generator=torch.Generator(device=device).manual_seed(args.seed),
                    device=device)
    tp, ip = (torch.from_numpy(a).to(device)
              for a in rs_ops.partition_permutations(args.seed, P, K, delta))
    want = rsp_shuffle_plain(x, tp, ip, tile_rows=delta)
    cands = rs_ops.shuffle_candidates(delta, 29 * 4,
                                      smem_limit=_cuda.library().repro_smem_optin())
    for c in cands:
        got = rsp_shuffle_cuda(x, tp, ip, tile_rows=delta, path=c.get("path"),
                               threads=c.get("threads"))
        check(bool(torch.equal(got, want)), f"rsp_shuffle {c.label}: differs from the plain gather")
    del got, want
    rs_ops.shuffle_config(x, tp, ip, delta)
    out["records"]["rsp_shuffle"] = tuner_record("rsp_shuffle", rs_ops.shuffle_key(x, delta),
                                                 device, gpu)
    del x, tp, ip
    # phase 3f partitions the corpus with P = K = MESH_HOSTS through the cuda
    # backend too (the collective's yardstick): tiles of N / MESH_HOSTS^2
    d = MESH_HOSTS
    x = torch.randn((d, args.records // d, 29), device=device,
                    generator=torch.Generator(device=device).manual_seed(args.seed + 1))
    tile = args.records // (d * d)
    tp, ip = (torch.from_numpy(a).to(device)
              for a in rs_ops.partition_permutations(args.seed, d, d, tile))
    want = rsp_shuffle_plain(x, tp, ip, tile_rows=tile)
    for c in rs_ops.shuffle_candidates(tile, 29 * 4,
                                       smem_limit=_cuda.library().repro_smem_optin()):
        got = rsp_shuffle_cuda(x, tp, ip, tile_rows=tile, path=c.get("path"),
                               threads=c.get("threads"))
        check(bool(torch.equal(got, want)), f"rsp_shuffle {c.label}: differs from the plain gather")
    del got, want
    rs_ops.shuffle_config(x, tp, ip, tile)
    out["records"]["rsp_shuffle, the mesh's partition"] = tuner_record(
        "rsp_shuffle", rs_ops.shuffle_key(x, tile), device, gpu)
    del x, tp, ip
    phase("autotune rsp_shuffle", t0, f"{len(cands)} configurations, each equal to the plain"
          f" gather bit for bit, at [{P}, {R}, 29] tile {delta}, and the row kernel's at"
          f" [{d}, {args.records // d}, 29] tile {tile} (phase 3f's cuda partition)")

    t0 = time.perf_counter()
    blk = make_block(n, args.seed + 1, device)
    glo, ghi = grid_of(blk)
    lo, invw = bs_ops.grid_tensors(glo, ghi, BINS, device)
    # the drift monitor sketches its reference blocks' 28 features
    features = blk[:, :28].contiguous()
    for xb, bins in ((blk, BINS), (blk, 0), (features, 0)):
        f = xb.shape[1]
        s2, h2 = block_sketch_plain(xb, lo[:f], invw[:f], bins=bins)
        cands = bs_ops.block_sketch_candidates(bins)
        for c in cands:
            s1, h1 = block_sketch_cuda(xb, lo[:f], invw[:f], bins=bins, config=bs_ops.as_config(c))
            compare_sketch(f"block_sketch {c.label} F={f} bins={bins}", s1, s2, h1, h2, errs)
        bs_ops.sketch_config(xb, lo[:f], invw[:f], bins=bins)
        out["records"][f"block_sketch F{f} b{bins}"] = tuner_record(
            "block_sketch", bs_ops.sketch_key(n, f, bins), device, gpu)
    del features
    phase("autotune block_sketch", t0, f"{len(bs_ops.block_sketch_candidates(BINS))} and"
          f" {len(bs_ops.block_sketch_candidates(0))} configurations at [{n}, 29], bins"
          f" {BINS} and 0, and at [{n}, 28], bins 0 (the drift monitor's); each within"
          f" {MOMENT_RTOL} of the plain version, counts and histograms equal")

    t0 = time.perf_counter()
    plans = {"query (b)": (QueryPlan(predicates="c0 > 0.5", columns=(0, 28)), (0,)),
             "query (c)": (QueryPlan(group_by=28, num_classes=2), (0, BINS))}
    for name, (plan, bin_counts) in plans.items():
        cols = plan.resolve_columns(29)
        arrays = {p: PlanArrays.build(plan, 29, device, path=p) for p in ("stage", "gather")}
        for bins in bin_counts:
            plo = pinvw = None
            if bins:
                plo, pinvw = bs_ops.grid_tensors(*grid_of(blk, cols), bins, device)
            s2, h2, n2 = plan_sketch_plain(blk, plan, plo, pinvw, bins=bins)
            for c in plan_ops.plan_candidates(bins):
                s1, h1, n1 = plan_sketch_cuda(blk, arrays[c.get("path")], plo, pinvw, bins=bins,
                                              config=plan_ops.as_config(c))
                check(bool(torch.equal(n1, n2)), f"plan {name} {c.label}: nsel differs")
                compare_sketch(f"plan {name} {c.label} bins={bins}", s1, s2, h1, h2, errs)
            plan_ops.plan_config(plan, blk, plo, pinvw, bins=bins)
            out["records"][f"plan_sketch {name} b{bins}"] = tuner_record(
                "plan_sketch", plan_ops.plan_key(plan, n, 29, bins), device, gpu)
    phase("autotune plan_sketch", t0, f"{len(plan_ops.plan_candidates(BINS))} configurations"
          f" a key at [{n}, 29]: query (b)'s plan at 0 bins, query (c)'s at 0 and {BINS}; each"
          f" within {MOMENT_RTOL} of the plain version, counts, nsel and histograms equal")
    out["max_abs_err"] = max(errs)
    out["measurements"] = tuner.measurements
    return out


def tuner_measurements() -> int:
    from repro_torch.kernels import autotune

    return autotune.get_tuner().measurements


def no_new_tuning(before: int, where: str) -> int:
    """Gate: the tuner measured nothing since ``before`` (tuning time must
    not land in a query's latency); prints the count."""
    now = tuner_measurements()
    print(f"autotune: {now - before} new tuner measurements on {where}", flush=True)
    check(now == before, f"the tuner measured {now - before} keys on {where}")
    return now


def row_order(x):
    """Rows of ``x [N, F]`` (4-byte values) sorted by a 64-bit hash of
    their bits, on its device."""
    import torch

    words = x.reshape(x.shape[0], -1).contiguous().view(torch.int32).to(torch.int64)
    mult = torch.tensor([(i * 0x9E3779B97F4A7C15) % (1 << 61) | 1
                         for i in range(1, words.shape[1] + 1)], device=x.device)
    h = (words * mult).sum(1) ^ (words[:, 0] << 32)
    return x.reshape(x.shape[0], -1)[torch.argsort(h)], torch.sort(h).values


def same_rows(blocks, data) -> bool:
    """Definition 2 on the card: the blocks' rows and the corpus's, sorted
    by their hashes, equal bit for bit (distinct rows that share a hash
    could only make it fail, never pass wrongly)."""
    import torch

    a, ha = row_order(blocks.reshape(-1, blocks.shape[-1]))
    b, hb = row_order(data)
    return bool(torch.equal(ha, hb)) and bool(torch.equal(a.view(torch.int32),
                                                          b.view(torch.int32)))


def torch_backend(args, data, device, cuda_s: float) -> dict:
    """Phase 3g: the HIGGS corpus partitioned by the ``torch`` backend on
    the card (host permutations from a CPU generator, one gather on the
    card): Definition 2 against the corpus; a 1/10 slice's blocks on the
    card equal to the CPU's bit for bit; no kernel launched."""
    import torch

    from repro_torch import kernels, rsp

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = rsp.partition(data, blocks=BLOCKS, seed=args.seed, num_classes=2, summaries=False,
                       backend="torch", device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(ds.backend == "torch", f"backend {ds.backend}")
    check(sum(counts.values()) == 0, f"the torch backend launched kernels: {counts}")
    blocks = ds.stacked()
    check(blocks.device == device and tuple(blocks.shape) == (BLOCKS, args.records // BLOCKS, 29),
          f"blocks {blocks.shape} on {blocks.device}")
    x_dev = torch.from_numpy(data).to(device)
    part = same_rows(blocks, x_dev)
    check(part, "torch backend: the blocks are not a partition of the corpus (Definition 2)")
    del blocks, x_dev
    ds.close()
    m = max(BLOCKS * BLOCKS, args.records // 10 // (BLOCKS * BLOCKS) * BLOCKS * BLOCKS)
    card = rsp.partition(data[:m], blocks=BLOCKS, seed=args.seed, summaries=False,
                         backend="torch", device=device).stacked()
    cpu = rsp.partition(data[:m], blocks=BLOCKS, seed=args.seed, summaries=False,
                        backend="torch", device="cpu").stacked()
    equal = bool(torch.equal(card.cpu(), cpu))
    check(equal, f"torch backend: the card's blocks of {m} rows differ from the CPU's")
    del card, cpu
    torch.cuda.empty_cache()
    phase("torch backend", t0, f"{seconds:.4f} s for [{args.records}, 29] into {BLOCKS} blocks"
          f" (the cuda backend: {cuda_s:.4f} s); Definition 2 holds; {m} rows: the card's"
          " blocks equal the CPU's bit for bit; no kernel launched")
    return {"seconds": seconds, "cuda_seconds": cuda_s, "definition_2": part,
            "card_equals_cpu_rows": m}


# ---------------------------------------------------------------------------
# Phases 3b, 3c and 3e: ingest from disk, block-level estimation, concurrent serving
# ---------------------------------------------------------------------------

INGEST_SAMPLE_S = 0.001   # the ingest child reads its memory this often
# The ingest's heap holds its scatter window (8 segments of ~8 MiB chunks,
# their row copies and float64 views) and the 100 blocks' sketch states: a
# few hundred MB.  A scatter that held the 1.276 GB corpus would exceed it.
INGEST_HEAP_BYTES = 512 << 20
SERVE_SEED = 11
SERVE_TYPES = ("sketch", "p95", "b_where_columns", "c_by_label")
PROFILED_TENANTS = 8          # the profiled wave's tenants, two of each type


def _status_bytes(*fields: str) -> list[int]:
    """``/proc/self/status`` fields, in bytes.  ``VmData`` is the size of the
    process's private writable mappings (its heap, resident or not, and no
    mapped file); ``VmRSS`` its resident memory, mapped files included."""
    got = {}
    with open("/proc/self/status") as f:
        for line in f:
            name, _, value = line.partition(":")
            if name in fields:
                got[name] = int(value.split()[0]) * 1024
    return [got[name] for name in fields]


def ingest_child(npy: str, out: str, seed: int, device: str) -> dict:
    """The ingest as a user runs it, in a process of its own so that its
    memory is its own: ``rsp.from_source(npy, out=...)`` with the default
    chunks and 4 scatter workers.  Returns the backend it chose, its seconds
    and the peak growth of the process's heap (``VmData``, where a
    materialized corpus would show) and of its resident memory (``VmRSS``:
    the pages of the mapped input and output files too), both read every
    INGEST_SAMPLE_S on a thread."""
    import threading

    from repro_torch import rsp
    from repro_torch.device import resolve_device

    resolve_device(device)
    base = _status_bytes("VmData", "VmRSS")
    peak, stop = list(base), threading.Event()

    def sample():
        while not stop.is_set():
            peak[:] = map(max, peak, _status_bytes("VmData", "VmRSS"))
            stop.wait(INGEST_SAMPLE_S)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    ds = rsp.from_source(npy, blocks=BLOCKS, seed=seed, num_classes=2, out=out, device=device)
    seconds = time.perf_counter() - t0
    stop.set()
    sampler.join()
    return {"backend": ds.backend, "seconds": seconds, "records": ds.spec.num_records,
            "rows_per_s": ds.spec.num_records / seconds,
            "peak_heap_growth_bytes": peak[0] - base[0],
            "peak_rss_growth_bytes": peak[1] - base[1], "sample_s": INGEST_SAMPLE_S}


def ingest_start(args, data, tmp: str, device) -> dict:
    """Phase 3b, first half: the HIGGS corpus written to a ``.npy`` file and
    the ingest child started on it (a host process); the card-bound phases
    that need no ingested store run while it works (``ingest``)."""
    import numpy as np

    npy, out = str(Path(tmp) / "corpus.npy"), str(Path(tmp) / "ingested.rsp")
    t0 = time.perf_counter()
    np.save(npy, data)
    phase("ingest write", t0, f"{Path(npy).stat().st_size / 1e9:.3f} GB .npy")
    logs = [open(Path(tmp) / name, "w+") for name in ("ingest.out", "ingest.err")]
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ingest-child", npy, out,
         str(device), "--seed", str(args.seed)], stdout=logs[0], stderr=logs[1], text=True)
    return {"proc": proc, "logs": logs, "out": out, "t0": time.perf_counter()}


def ingest(args, data, child: dict, device) -> dict:
    """Phase 3b: the ingest child started by ``ingest_start`` (the corpus
    ingested from disk into a stored RSP by the out-of-core scatter) waited
    for, checked bit for bit against ``two_stage_partition_np`` of the
    same array on the host, its folded sketches against the in-memory np
    backend's summaries (the reference's tolerances, ``tests/test_ingest.py``),
    and query (b) on the reopened store against the same query on the np
    partition held on the card."""
    import numpy as np
    import torch

    from repro_torch import rsp
    from repro_torch.core.partition import two_stage_partition_np
    from repro_torch.rsp.summaries import summarize_blocks

    out, proc = child["out"], child["proc"]
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, 900 - (t0 - child["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    stdout, stderr = (f.seek(0) or f.read() for f in child["logs"])
    for f in child["logs"]:
        f.close()
    check(rc == 0, f"ingest child failed (exit {rc}): {stderr[-2000:]}")
    got = json.loads(stdout.strip().splitlines()[-1])
    got["waited_s"] = time.perf_counter() - t0
    phase("ingest", child["t0"], json.dumps(got))
    check(got["backend"] == "np_stream", f"from_source chose {got['backend']!r}")
    check(got["peak_heap_growth_bytes"] < INGEST_HEAP_BYTES,
          f"the ingest's heap grew by {got['peak_heap_growth_bytes']} bytes, more than"
          f" {INGEST_HEAP_BYTES} (the corpus is {data.nbytes})")

    t0 = time.perf_counter()
    ds = rsp.open(out, device=device, cache_blocks=BLOCKS)
    check(ds.backend == "np_stream", f"the reopened store says backend {ds.backend!r}")
    want = two_stage_partition_np(data, ds.spec)
    for k in range(BLOCKS):
        check(np.array_equal(ds.store.load_block(k), want[k]),
              f"ingested block {k} differs from two_stage_partition_np")
    phase("ingest check", t0, f"{BLOCKS} blocks equal two_stage_partition_np bit for bit")

    t0 = time.perf_counter()
    exact = summarize_blocks(want, label_column=-1, num_classes=2, kinds=("moments", "labels"))
    for k, (s, e) in enumerate(zip(ds.summaries, exact)):
        check(s.count == e.count, f"block {k}: count {s.count} vs {e.count}")
        check(np.allclose(s.mean, e.mean, rtol=1e-9, atol=1e-11), f"block {k}: mean differs")
        check(np.allclose(s.m2, e.m2, rtol=1e-7, atol=1e-9), f"block {k}: M2 differs")
        for f in ("min", "max", "label_hist"):
            check(np.array_equal(getattr(s, f), getattr(e, f)), f"block {k}: {f} differs")
    phase("ingest sketches", t0, "moments to rtol 1e-9 / 1e-7, extrema and labels exact")

    t0 = time.perf_counter()
    aggs, kw = queries()["b_where_columns"]
    in_memory = rsp.RSPDataset(ds.spec, blocks=want, backend="np", summaries=exact,
                               num_classes=2, device=device)
    r_store, r_mem = ds.query(aggs, **kw), in_memory.query(aggs, **kw)
    check(r_store.blocks_read == r_mem.blocks_read and agree(r_store, r_mem) == 0.0,
          "query (b) on the ingested store differs from the np partition's")
    in_memory.close()
    del in_memory, want
    torch.cuda.empty_cache()
    phase("ingest query", t0, f"query (b) equal on both, blocks_read={r_store.blocks_read}")
    return {"dataset": ds, "ingest": got}


def estimator(ds) -> dict:
    """Phase 3c: ``ds.estimator()`` over all blocks (one block_sketch launch
    a block, moments only) against the same estimator through the plain
    version, and ``ds.estimate`` of a plain torch statistic over 20 blocks
    against the estimator of the same 20."""
    import numpy as np
    import torch

    from repro_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = ds.estimator()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()   # the estimator's path ends here
    check(counts["block_sketch"] == BLOCKS and sum(counts.values()) == BLOCKS,
          f"estimator launches {counts}, expected {BLOCKS} of block_sketch alone")
    plain = ds.estimator(impl="torch")
    check(est.blocks_seen == plain.blocks_seen == BLOCKS, "the estimators read other blocks")
    worst = max(rel_err(getattr(est.stats, f), getattr(plain.stats, f))
                for f in ("mean", "m2", "min", "max"))
    check(worst <= MOMENT_RTOL, f"estimator: kernel and plain differ by {worst:.3g}")
    t1 = time.perf_counter()
    value = ds.estimate(lambda b: b.double().mean(0), g=20, seed=5)
    estimate_s = time.perf_counter() - t1
    sub = ds.estimator(g=20, seed=5, impl="torch").stats.mean
    dev = rel_err(value, sub)
    check(value.shape == (29,) and np.all(np.isfinite(value)) and dev <= MOMENT_RTOL,
          f"estimate over 20 blocks differs from the estimator of the same blocks by {dev:.3g}")
    phase("estimator", t0, f"{BLOCKS} blocks in {seconds:.3f} s, launches {json.dumps(counts)};"
          f" kernel vs plain {worst:.3g}; estimate(g=20) vs estimator {dev:.3g}")
    return {"counts": counts, "seconds": seconds, "estimate_s": estimate_s,
            "kernel_vs_plain": worst, "estimate_vs_estimator": dev}


# ---------------------------------------------------------------------------
# Phase 3d: learning from the blocks (Sec. 7, 9 and 10, the training loader)
# ---------------------------------------------------------------------------

LEARN_SEED = 7                # Algorithm 2's sampler and initial weights
LOGREG_STEPS = 300            # make_logreg's full-batch GD steps (its default)
EVAL_RECORDS = 200_000        # Fig. 6's evaluation set
ENSEMBLE_GAP = 0.01           # tests/test_ensemble.py:74
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4   # tests/test_ensemble.py:48-53
PROBA_TOL = 1e-5
SIM_SEED = 3
SIM_CPU_BLOCKS = 3            # blocks whose similarities are held against the CPU's
MON_SEED = 5
LOADER_BATCH = 8192
LOADER_CHECK = 40             # batches held against the CPU loader
LOADER_STATE_AT = 20          # the state_dict is taken after this batch
LOADER_PROFILED = 100         # batches in the profiled window


def learning_inputs(data, block_size: int) -> dict:
    """What the learning phase keeps of the class-sorted corpus before it is
    freed: its first ``block_size`` records (one sequential chunk, all of
    class 0) and the feature whose class means differ most (the KS probe)."""
    import numpy as np

    n0 = int(np.count_nonzero(data[:, 28] == 0))   # class-sorted: class 0 first
    gap = np.abs(data[:n0, :28].mean(0, dtype=np.float64)
                 - data[n0:, :28].mean(0, dtype=np.float64))
    return {"chunk": data[:block_size].copy(), "ks_feature": int(np.argmax(gap)),
            "class_mean_gap": float(gap.max())}


def heldout_higgs_like(num_records: int, seed: int, sample_seed: int):
    """``num_records`` fresh records of the corpus's own distribution,
    class-sorted: the class means and scales of
    ``make_higgs_like(seed=seed)`` (its first draws from
    ``default_rng(seed)``), the records drawn from ``default_rng(sample_seed)``.
    ``make_nonrandom_higgs_like(seed=seed + 1)`` would be another
    distribution: its informative direction is drawn from its own seed."""
    import numpy as np

    params = np.random.default_rng(seed)
    direction = params.normal(size=8).astype(np.float32)
    direction /= np.linalg.norm(direction)
    means = np.zeros((2, 28), np.float32)
    means[1, :8] = direction
    scale = params.uniform(0.8, 1.4, size=28).astype(np.float32)
    rng = np.random.default_rng(sample_seed)
    n1 = num_records // 2
    n0 = num_records - n1
    x = np.concatenate([rng.normal(size=(n, 28)).astype(np.float32) * scale + means[c]
                        for c, n in ((0, n0), (1, n1))])
    y = np.concatenate([np.zeros(n0, np.int32), np.ones(n1, np.int32)])
    return x, y


def row_keys(x):
    """One int64 key a record: the bits of its columns 0 and 1 (two
    continuous features, so the keys of distinct records differ)."""
    import torch

    bits = x[:, :2].contiguous().view(torch.int32).to(torch.int64)
    return (bits[:, 0] << 32) | (bits[:, 1] & 0xFFFFFFFF)


def ensemble_part(args, ds, host) -> dict:
    """Algorithm 2 on the card (``ds.ensemble``), the first batch's models
    against the CPU port's from the same weights, ``predict_proba`` against
    the CPU, Fig. 6's comparison with one model trained on every record,
    and the MLP learner's ensemble over 2 batches."""
    import numpy as np
    import torch

    from repro_torch.core import (
        Ensemble,
        ensemble_vs_single_model,
        make_logreg,
        make_mlp,
        train_base_models_vmapped,
    )

    t_part = time.perf_counter()
    dev = ds.device
    ex, ey = heldout_higgs_like(EVAL_RECORDS, args.seed, args.seed + 1)
    ex_dev, ey_dev = torch.from_numpy(ex).to(dev), torch.from_numpy(ey).to(dev)
    logreg = make_logreg(28, 2, steps=LOGREG_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens, hist = ds.ensemble(logreg, eval_x=ex_dev, eval_y=ey_dev, g=5, seed=LEARN_SEED)
    torch.cuda.synchronize()
    ensemble_s = time.perf_counter() - t0
    check(all(np.isfinite(v.cpu().numpy()).all() for v in ens.params.values()),
          "the ensemble's weights are not finite")

    t0 = time.perf_counter()
    cpu_ens, _ = host.ensemble(logreg, eval_x=ex, eval_y=ey, g=5, batches=1, seed=LEARN_SEED)
    cpu_first_s = time.perf_counter() - t0
    train_err = 0.0
    for k, want in cpu_ens.params.items():
        got = ens.params[k][:5].cpu()
        check(bool(torch.allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)),
              f"the first batch's {k} on the card differs from the CPU's")
        train_err = max(train_err, max_abs(got, want))
    on_host = Ensemble(logreg)
    on_host.add_stacked({k: v.cpu() for k, v in ens.params.items()}, ens.num_models)
    proba_err = max_abs(ens.predict_proba(ex_dev), on_host.predict_proba(torch.from_numpy(ex)))
    check(proba_err <= PROBA_TOL, f"predict_proba: card and CPU differ by {proba_err:.3g}")

    xs, ys = ds._split_xy(ds.take(range(ds.num_blocks)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens_acc, single_acc = ensemble_vs_single_model(xs, ys, ex_dev, ey_dev, learner=logreg,
                                                   seed=LEARN_SEED)
    torch.cuda.synchronize()
    fig6_s = time.perf_counter() - t0
    check(ens_acc >= single_acc - ENSEMBLE_GAP,
          f"ensemble accuracy {ens_acc:.4f} is not within {ENSEMBLE_GAP} of the single"
          f" full-data model's {single_acc:.4f}")
    t0 = time.perf_counter()
    single = logreg.fit(logreg.init(torch.Generator().manual_seed(LEARN_SEED + 1)),
                        xs.reshape(-1, 28), ys.reshape(-1))
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    check(all(bool(torch.isfinite(v).all()) for v in single.values()),
          "the single model's weights are not finite")
    records = int(ys.numel())
    # where a GD step's time goes: one profiled batch of 5 models and one
    # profiled single model, beside the least time of their GD steps (each
    # step reads the features twice: the logits and the weight gradient)
    gen = torch.Generator().manual_seed(LEARN_SEED)
    runs = {"batch of 5": (xs[:5], lambda: train_base_models_vmapped(logreg, gen, xs[:5], ys[:5])),
            "single model": (xs, lambda: logreg.fit(logreg.init(gen), xs.reshape(-1, 28),
                                                    ys.reshape(-1)))}
    prof = {}
    for name, (feats, run) in runs.items():
        wall, busy, by_name, events = profiled(run)
        prof[name] = {"wall_s": wall, "busy_s": busy,
                      "idle_share": None if busy is None else 1.0 - busy / wall,
                      "events": events,
                      "bytes_bound_s": LOGREG_STEPS * 2 * feats.numel() * 4 / HBM_BYTES_PER_S,
                      "top": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:4])}
    del xs, ys

    t0 = time.perf_counter()
    mlp_ens, mlp_hist = ds.ensemble(make_mlp(28, 2), eval_x=ex_dev, eval_y=ey_dev, g=5,
                                    batches=2, seed=LEARN_SEED)
    torch.cuda.synchronize()
    mlp_s = time.perf_counter() - t0
    out = {"blocks_used": hist.blocks_used, "accuracy": hist.accuracy,
           "ensemble_s": ensemble_s, "cpu_first_batch_s": cpu_first_s,
           "first_batch_max_abs": train_err, "predict_proba_max_abs": proba_err,
           "fig6": {"ensemble_acc": ens_acc, "single_acc": single_acc, "seconds": fig6_s,
                    "single_records": records},
           "single_s": single_s, "profiled": prof,
           "mlp": {"blocks_used": mlp_hist.blocks_used, "accuracy": mlp_hist.accuracy,
                   "seconds": mlp_s}}
    phase("learning ensemble", t_part, json.dumps(out))
    return out


def similarity_part(ds, host, inputs: dict) -> dict:
    """Sec. 7 on every block of the store (MMD^2, KS on the feature whose
    class means differ most, label divergence) against the sequential
    chunk scored the same way, Hotelling's test, and 3 blocks against the
    CPU port."""
    import torch

    from repro_torch.core import hotelling_t2, ks_statistic, max_label_divergence
    from repro_torch.core import mmd_block_vs_data

    K, f = ds.num_blocks, inputs["ks_feature"]
    metrics = ("mmd", "ks", "labels")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sims = {m: [ds.similarity(k, metric=m, feature=f, seed=SIM_SEED) for k in range(K)]
            for m in metrics}
    sweep_s = time.perf_counter() - t0

    ref = ds._corpus_reference(4096, seed=SIM_SEED)
    chunk = torch.from_numpy(inputs["chunk"]).to(ds.device)
    seq = {"mmd": mmd_block_vs_data(chunk, ref, seed=SIM_SEED),
           "ks": ks_statistic(chunk[:, f], ref[:, f]),
           "labels": max_label_divergence(chunk[:, 28], ref[:, 28], 2)}
    misses = {
        "mmd": [k for k, v in enumerate(sims["mmd"]) if not (v < seq["mmd"] / 5 and abs(v) < 5e-3)],
        "ks": [k for k, v in enumerate(sims["ks"]) if not v < seq["ks"]],
        "labels": [k for k, v in enumerate(sims["labels"]) if not v < 0.05],
    }
    worst = {m: max(sims[m], key=abs) for m in metrics}
    print(f"similarity: worst block {json.dumps(worst)}, sequential chunk {json.dumps(seq)},"
          f" KS feature {f}, blocks missing a gate {json.dumps(misses)}", flush=True)
    for m in metrics:
        check(not misses[m], f"similarity {m}: blocks {misses[m]} are not closer to the corpus"
                             " than the sequential chunk")

    ref0 = ds._corpus_reference(4096, seed=SIM_SEED, exclude=0)
    _, _, p_block = hotelling_t2(ds.block(0)[:, :28], ref0[:, :28])
    _, _, p_chunk = hotelling_t2(chunk[:, :28], ref[:, :28])
    check(p_block > 0.001, f"Hotelling: block 0 p = {p_block:.3g}, not above 0.001")
    check(p_chunk < 1e-6, f"Hotelling: the sequential chunk's p = {p_chunk:.3g}, not below 1e-6")

    probes = [0, K // 2, K - 1][:SIM_CPU_BLOCKS]
    cpu_err = 0.0
    for k in probes:
        for m in metrics:
            got, want = sims[m][k], host.similarity(k, metric=m, feature=f, seed=SIM_SEED)
            if m == "mmd":
                cpu_err = max(cpu_err, abs(got - want) / (1 + abs(want)))
            else:
                check(got == want, f"similarity {m} of block {k}: card {got} vs CPU {want}")
    check(cpu_err <= MOMENT_RTOL, f"MMD^2 on the card and the CPU differ by {cpu_err:.3g}")
    out = {"sweep_s": sweep_s, "calls": K * len(metrics), "worst": worst, "sequential": seq,
           "ks_feature": f, "hotelling_p": {"block 0": p_block, "sequential": p_chunk},
           "cpu_blocks": probes, "mmd_card_vs_cpu": cpu_err}
    phase("learning similarity", t0, json.dumps(out))
    return out


def monitor_part(ds) -> dict:
    """Sec. 10: a DriftMonitor on 5 sampled blocks (5 block_sketch launches),
    the other blocks scored (none flagged), three corrupted blocks (all
    flagged), and every report against a monitor on the CPU."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import DriftMonitor

    ids = ds.sample(5, seed=MON_SEED)
    ref_blocks = ds.take(ids)[..., :28]
    others = [k for k in range(ds.num_blocks) if k not in ids]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mon = DriftMonitor(ref_blocks, device=ds.device)
    build_s = time.perf_counter() - t0
    clean = [mon.score(ds.block(k)[:, :28], block_id=k) for k in others]
    torch.cuda.synchronize()
    monitor_s = time.perf_counter() - t0
    base = ds.block(others[0])[:, :28]
    zeroed = base.clone()
    zeroed[:, 3] = 0.0
    rng = np.random.default_rng(7)
    t_block = rng.standard_t(df=1.5, size=tuple(base.shape)).astype(np.float32)
    t_block = t_block - t_block.mean(0) + ref_blocks.reshape(-1, 28).cpu().numpy().mean(0)
    bad_blocks = {"shifted +1.5": base + 1.5, "column 3 zeroed": zeroed,
                  "t(1.5)": torch.from_numpy(t_block).to(ds.device)}
    bad = {name: mon.score(b, block_id=-1 - i) for i, (name, b) in enumerate(bad_blocks.items())}
    counts = kernels.launch_counts()   # the monitor's path ends here
    check(counts["block_sketch"] == 5 and sum(counts.values()) == 5,
          f"monitor launches {counts}, expected 5 of block_sketch alone")
    flagged = [r.block_id for r in clean if r.drifted]
    check(not flagged, f"clean blocks flagged: {flagged}")
    missed = [name for name, r in bad.items() if not r.drifted]
    check(not missed, f"corrupted blocks not flagged: {missed}")

    t1 = time.perf_counter()
    host = DriftMonitor(ref_blocks.cpu(), device="cpu")
    want = [host.score(ds.block(k)[:, :28].cpu(), block_id=k) for k in others]
    want += [host.score(b.cpu(), block_id=-1 - i) for i, b in enumerate(bad_blocks.values())]
    cpu_s = time.perf_counter() - t1
    err = 0.0
    for got, w in zip(clean + list(bad.values()), want):
        check(got.drifted == w.drifted, f"block {got.block_id}: flags differ on card and CPU")
        for field in ("mmd2", "max_mean_z", "worst_std_ratio"):
            err = max(err, rel_err(getattr(got, field), getattr(w, field)))
    check(err <= MOMENT_RTOL, f"monitor reports: card and CPU differ by {err:.3g}")
    out = {"reference_blocks": ids, "launches": counts, "build_s": build_s,
           "seconds": monitor_s, "scored": len(others), "mmd_threshold": mon.mmd_threshold,
           "worst_clean": {f: max(getattr(r, f) for r in clean)
                           for f in ("mmd2", "max_mean_z", "worst_std_ratio")},
           "corrupted": {n: dataclasses.asdict(r) for n, r in bad.items()},
           "card_vs_cpu": err, "cpu_s": cpu_s}
    phase("learning monitor", t0, json.dumps(out))
    return out


def loader_part(ds, host, records: int) -> dict:
    """The training loader over the store: 40 batches equal to a CPU
    loader's bit for bit, a resume from the state after batch 20, one timed
    epoch, one checked epoch (no record twice, column sums equal to the
    corpus's less the dropped tail) and one profiled window."""
    import torch

    from repro_torch.core import BlockSampler

    seed = LEARN_SEED
    t0 = time.perf_counter()
    loader, host_loader = ds.loader(LOADER_BATCH, seed=seed), host.loader(LOADER_BATCH, seed=seed)
    first, state = [], None
    for i in range(LOADER_CHECK):
        first.append(loader.next_batch())
        check(bool(torch.equal(first[-1].cpu(), host_loader.next_batch())),
              f"loader batch {i}: card and CPU differ")
        if i + 1 == LOADER_STATE_AT:
            state = loader.state_dict()
    resumed = ds.loader(LOADER_BATCH, seed=seed)
    resumed.load_state_dict(state)
    for i in range(LOADER_STATE_AT, LOADER_CHECK):
        check(bool(torch.equal(resumed.next_batch(), first[i])),
              f"loader batch {i} after the resume differs")
    for ld in (loader, host_loader, resumed):
        ld.close()
    del first

    n_batches = records // LOADER_BATCH
    loader = ds.loader(LOADER_BATCH, seed=seed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_batches):
        loader.next_batch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t1
    wall, busy, by_name, events = profiled(
        lambda: [loader.next_batch() for _ in range(LOADER_PROFILED)])
    loader.close()

    checked = ds.loader(LOADER_BATCH, seed=seed)
    keys, sums = [], torch.zeros(29, dtype=torch.float64, device=ds.device)
    for _ in range(n_batches):
        b = checked.next_batch()
        keys.append(row_keys(b))
        sums += b.double().sum(0)
    checked.close()
    # the dropped tail: the rest of epoch 0 in the sampler's block order
    # (every block holds ds.block_size records)
    order = BlockSampler(ds.num_blocks, seed=seed).sample(ds.num_blocks)
    tail_blocks = set(order[n_batches * LOADER_BATCH // ds.block_size:])
    keys = torch.cat(keys)
    check(int(torch.unique(keys).numel()) == keys.numel(), "the epoch gave a record twice")
    corpus_sums = torch.zeros_like(sums)
    tail_sums = torch.zeros_like(sums)
    seen, tail, in_blocks = 0, 0, set()
    for k in range(ds.num_blocks):
        blk = ds.block(k)
        bk = row_keys(blk)
        check(int(torch.unique(bk).numel()) == bk.numel(), f"block {k} repeats a record key")
        used = torch.isin(bk, keys)
        seen += int(used.sum())
        corpus_sums += blk.double().sum(0)
        if not bool(used.all()):
            tail += int((~used).sum())
            tail_sums += blk[~used].double().sum(0)
            in_blocks.add(k)
    check(seen == keys.numel(), f"{keys.numel() - seen} batch records are not in the corpus")
    check(tail == records - keys.numel() and in_blocks == tail_blocks,
          f"dropped tail: {tail} records in blocks {sorted(in_blocks)}, expected"
          f" {records - keys.numel()} in the rest of epoch 0, {sorted(tail_blocks)}")
    dev_sum = rel_err(sums, corpus_sums - tail_sums)
    check(dev_sum <= 1e-9, f"epoch column sums differ from the corpus less its tail by {dev_sum:.3g}")
    idle = None if busy is None else 1.0 - busy / wall
    out = {"batch": LOADER_BATCH, "epoch_batches": n_batches, "epoch_s": epoch_s,
           "records_per_s": n_batches * LOADER_BATCH / epoch_s, "dropped_tail": tail,
           "column_sums_vs_corpus": dev_sum,
           "profiled": {"batches": LOADER_PROFILED, "wall_s": wall, "busy_s": busy,
                        "idle_share": idle, "events": events,
                        "top": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:4])}}
    phase("learning loader", t0, json.dumps(out))
    return out


def learning(args, ds, inputs: dict) -> dict:
    """Phase 3d: Sec. 9's Algorithm 2 and Fig. 6, Sec. 7's similarity
    toolkit, Sec. 10's drift monitor and the training loader, on the
    ingested store on the card, each held against the CPU port."""
    from repro_torch import rsp

    t0 = time.perf_counter()
    host = rsp.open(ds.store.root, device="cpu")
    out = {"ensemble": ensemble_part(args, ds, host),
           "similarity": similarity_part(ds, host, inputs),
           "monitor": monitor_part(ds),
           "loader": loader_part(ds, host, ds.spec.num_records)}
    host.close()
    out["seconds"] = time.perf_counter() - t0
    phase("learning", t0, f"ensemble, similarity, monitor and loader in {out['seconds']:.1f} s")
    return out


def serve_tenants() -> dict:
    """The tenant types, by name: a sketch answer, a p95 of one column over
    20 blocks (bounding the host bootstrap, O(b^2) in blocks), query (b)
    and query (c)."""
    from repro_torch.rsp import Aggregate

    q = queries()
    return {
        "sketch": (["mean", "var", "count"], {}),
        "p95": (Aggregate("quantile", q=0.95, feature=0), dict(use_sketches=False, max_blocks=20)),
        "b_where_columns": q["b_where_columns"],
        "c_by_label": q["c_by_label"],
    }


def serve_specs():
    """The 32 tenants of a wave, 8 of each type, interleaved."""
    one = serve_tenants()
    return [(kind, *one[kind]) for _ in range(8) for kind in SERVE_TYPES]


def serve_wave(ds, specs, *, workers: int = 8, capacity: int = 64):
    """Submit every tenant from 4 threads to a fresh service; returns the
    tickets (in spec order), their results and the service's metrics."""
    import threading

    tickets = [None] * len(specs)
    with ds.serve(capacity=capacity, workers=workers, seed=SERVE_SEED) as svc:

        def submit(first):
            for i in range(first, len(specs), 4):
                _, aggs, kw = specs[i]
                tickets[i] = svc.submit(aggs, **kw)

        threads = [threading.Thread(target=submit, args=(j,)) for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "a submitter thread hung")
        results = [svc.result(t, timeout=600) for t in tickets]
        metrics = svc.metrics()
    return tickets, results, metrics


def serving(store: str, device) -> dict:
    """Phase 3e: 32 tenants served concurrently on the ingested store,
    reopened cold with room for every block in its cache, each answer equal
    to its solo run bit for bit, the sketch kernels launched once for every
    block a progressive query folded; then a saturation wave, a deadline
    wave and one profiled wave (warm)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels, rsp
    from repro_torch.rsp.engine import ExecutorStats
    from repro_torch.rsp.query import QueryExecutor, as_query, derive_seed
    from repro_torch.serve.query_service import _percentile

    specs = serve_specs()
    ds = rsp.open(store, device=device, cache_blocks=BLOCKS)
    before = ds.executor.stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets, results, m = serve_wave(ds, specs)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()   # the serve path ends here
    window = ds.executor.stats() - before
    folded = {kind: sum(r.blocks_read for (k, _, _), r in zip(specs, results) if k == kind)
              for kind in SERVE_TYPES}
    check(counts["block_sketch"] == folded["p95"],
          f"block_sketch launched {counts['block_sketch']} times for {folded['p95']} blocks")
    check(counts["plan_sketch"] == folded["b_where_columns"] + folded["c_by_label"],
          f"plan_sketch launched {counts['plan_sketch']} times for"
          f" {folded['b_where_columns'] + folded['c_by_label']} blocks")
    check(folded["sketch"] == 0 and all(folded[k] > 0 for k in SERVE_TYPES[1:]),
          f"blocks folded by type {folded}")
    total = sum((t.result.executor_stats for t in tickets), ExecutorStats())
    check((total.hits, total.misses) == (window.hits, window.misses),
          f"per-query stats {total} do not sum to the executor's window {window}")
    check(m.submitted == m.completed == len(specs) and m.failed == 0 and m.rejected == 0,
          f"wave metrics {m}")
    outcomes = {kind: sorted({t.outcome for (k, _, _), t in zip(specs, tickets) if k == kind})
                for kind in SERVE_TYPES}
    phase("serve", t0, f"{len(specs)} tenants from 4 threads, 8 workers; outcomes"
          f" {json.dumps(outcomes)}; launches {json.dumps(counts)}; blocks folded"
          f" {json.dumps(folded)}")

    t0 = time.perf_counter()
    solo_ds = rsp.open(store, device=device, cache_blocks=BLOCKS)
    for (kind, aggs, kw), t, r in zip(specs, tickets, results):
        q = dataclasses.replace(as_query(aggs, **kw), seed=derive_seed(SERVE_SEED, t.id))
        solo = QueryExecutor(solo_ds, q).run()
        same = (r.blocks_read, r.converged) == (solo.blocks_read, solo.converged) and all(
            np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), equal_nan=True)
            for a, b in zip(r.aggregates, solo.aggregates) for f in ("estimate", "ci_lo", "ci_hi"))
        check(same, f"tenant {t.id} ({kind}): served answer differs from its solo run")
    solo_ds.close()
    phase("serve check", t0, "every served answer equals its solo run bit for bit;"
          " per-query stats sum to the executor's window")

    lat = {kind: sorted(t.latency_ms for (k, _, _), t in zip(specs, tickets) if k == kind)
           for kind in SERVE_TYPES}
    wave = {
        "wall_s": wall, "qps": m.qps, "latency_p50_ms": m.latency_p50_ms,
        "latency_p99_ms": m.latency_p99_ms, "blocks_per_query": m.blocks_per_query,
        "blocks_folded_per_progressive_query": sum(folded.values()) / (len(specs) * 3 / 4),
        "blocks_fetched": m.blocks_fetched, "cache_hit_rate": m.cache_hit_rate,
        "rejected": m.rejected, "launches": counts, "blocks_folded": folded,
        "by_type": {kind: {"p50_ms": _percentile(v, 0.50), "p99_ms": _percentile(v, 0.99),
                           "outcomes": outcomes[kind]} for kind, v in lat.items()},
    }

    # saturation: one p95 tenant holds the whole capacity (its cost is
    # prefetch + 1 = 5 fetch slots), two wait, the rest are refused
    t0 = time.perf_counter()
    with ds.serve(capacity=5, max_queue=2, workers=2, seed=SERVE_SEED + 1) as svc:
        aggs, kw = serve_tenants()["p95"]
        sat = [svc.submit(aggs, on_reject="ticket", **kw) for _ in range(16)]
        for t in sat:
            t.wait(600)
        ms = svc.metrics()
    check(all(t.done for t in sat), "a saturation-wave ticket never finished")
    check(ms.submitted == 16 == ms.completed + ms.rejected and ms.rejected >= 1
          and ms.admission.rejected_total == ms.rejected and ms.failed == 0,
          f"saturation metrics {ms}")
    phase("serve saturation", t0, f"16 submissions: {ms.rejected} rejected,"
          f" {ms.completed} completed, queue {ms.admission}")

    # deadlines: p95 over up to 100 blocks with 50 ms to answer
    t0 = time.perf_counter()
    with ds.serve(capacity=64, workers=8, seed=SERVE_SEED + 2) as svc:
        aggs = serve_tenants()["p95"][0]
        dl = [svc.submit(aggs, use_sketches=False, max_blocks=BLOCKS, deadline_ms=50)
              for _ in range(8)]
        for t in dl:
            t.wait(600)
        md = svc.metrics()
    check(all(t.outcome in ("deadline", "converged") and t.result is not None for t in dl)
          and md.failed == 0, f"deadline wave outcomes {[t.outcome for t in dl]}")
    deadline = {"outcomes": [t.outcome for t in dl],
                "blocks_read": [t.result.blocks_read for t in dl],
                "latency_ms": [t.latency_ms for t in dl],
                "overrun_ms": [max(0.0, (t.finished_at - t.deadline) * 1e3) for t in dl]}
    phase("serve deadlines", t0, json.dumps(deadline))

    # the device's idle share of a wave: the first PROFILED_TENANTS tenants,
    # every type alike (a whole wave's profile took 34 s of the smoke)
    t0 = time.perf_counter()
    p_wall, busy, by_name, _ = profiled(lambda: serve_wave(ds, specs[:PROFILED_TENANTS]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    share = {"wall_s": p_wall, "busy_s": busy,
             "idle_share": None if busy is None else 1 - busy / p_wall,
             "top": [(name[:60], sec) for name, sec in top]}
    phase("serve profile", t0, f"one profiled wave of {PROFILED_TENANTS} tenants:"
          f" {json.dumps(share)}")
    ds.close()
    return {"wave": wave, "saturation": {"rejected": ms.rejected, "completed": ms.completed},
            "deadline": deadline, "device_share": share}


# ---------------------------------------------------------------------------
# Phase 3f: the multi-host RSP layer (threads, processes, the collective)
# ---------------------------------------------------------------------------

MESH_HOSTS = 4
MESH_GRACE = 2.0           # seconds a host waits for a peer's payload before stealing
MESH_CHILD_TIMEOUT = 60.0  # a mesh or partition child past this fails the phase
MESH_TYPES = ("b_where_columns", "c_by_label", "p95")
PAYLOAD_KEY = "/p/"        # DistributedQueryExecutor publishes payloads under {ns}/p/{position}


def mesh_queries() -> dict:
    """Query (b), query (c) and the p95 of column 0 over 20 blocks (query
    (a) reads all 100 blocks, so four hosts would each run its host
    bootstrap)."""
    tenants = serve_tenants()
    return {name: tenants[name] for name in MESH_TYPES}


def result_sig(r) -> str:
    """A result's bit-exact signature: the fields of
    ``tests/test_distributed_query.py``'s ``_sig``."""
    import numpy as np

    def flat(v):
        return None if v is None else np.asarray(v).ravel().tolist()

    return json.dumps({
        "est": {a.name: flat(a.estimate) for a in r.aggregates},
        "lo": {a.name: flat(a.ci_lo) for a in r.aggregates},
        "hi": {a.name: flat(a.ci_hi) for a in r.aggregates},
        "blocks_read": r.blocks_read, "converged": r.converged, "selectivity": r.selectivity,
    }, sort_keys=True)


def steal_seconds() -> dict:
    """``{host: {"steals": n, "seconds": s}}`` from telemetry: each host's
    re-deals and its waits up to them (``rsp_mesh_steal_seconds``, from the
    first look for a position's payload to the re-deal of its holder's
    blocks, inside one run)."""
    from repro_torch import obs

    fam = obs.get_registry().snapshot().get("rsp_mesh_steal_seconds", {"series": []})
    return {int(r["labels"]["host"]): {"steals": r["count"], "seconds": r["sum"]}
            for r in fam["series"]}


class CountingTransport:
    """A transport that counts the payload bytes its host publishes."""

    def __init__(self, inner):
        self.inner = inner
        self.payloads = 0
        self.payload_bytes = 0

    host_id = property(lambda self: self.inner.host_id)
    num_hosts = property(lambda self: self.inner.num_hosts)

    def put(self, key: str, value: bytes) -> None:
        self.inner.put(key, value)
        if PAYLOAD_KEY in key:
            self.payloads += 1
            self.payload_bytes += len(value)

    def get(self, key: str, timeout: float = 0.0):
        return self.inner.get(key, timeout)

    def poll(self, prefix: str):
        return self.inner.poll(prefix)

    def beat(self, key: str) -> None:
        self.inner.beat(key)


def mesh_threads(ds, single: dict, *, kill: bool) -> dict:
    """Four ``LocalTransport`` hosts on threads, each ``ds.distribute(t)``
    with an ownership of 25 blocks, run the mesh queries in turn; with
    ``kill``, host 3 dies at its third publish.  Checks every surviving
    host's answers against the single-host ones bit for bit and the sketch
    launches against the payloads the hosts computed."""
    import torch

    from repro_torch import kernels, obs
    from repro_torch.distributed import LocalTransport, run_local_hosts

    transports = LocalTransport.group(MESH_HOSTS)
    if kill:
        transports[-1].kill_after_puts(2)
    counting = [CountingTransport(t) for t in transports]
    hosts: dict[int, object] = {}
    spans: dict[str, list] = {name: [] for name in MESH_TYPES}
    reads: dict[str, list] = {name: [0] * MESH_HOSTS for name in MESH_TYPES}

    def host(t):
        dds = ds.distribute(t, straggler_grace=MESH_GRACE)
        hosts[t.host_id] = dds
        check(len(dds.owned_blocks) == BLOCKS // MESH_HOSTS,
              f"host {t.host_id} owns {len(dds.owned_blocks)} blocks")
        sigs = {}
        for name, (aggs, kw) in mesh_queries().items():
            before = dds.executor.stats()
            t0 = time.perf_counter()
            try:
                r = dds.query(aggs, **kw)
            finally:
                reads[name][t.host_id] = (dds.executor.stats() - before).accesses
                spans[name].append((t0, time.perf_counter()))
            sigs[name] = result_sig(r)
        return sigs, dds.ownership.hosts()

    obs.reset()
    obs.enable()   # the steal waits; both runs alike
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_local_hosts(counting, host)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()   # the mesh query path ends here
    steals = steal_seconds()
    obs.reset()
    check(bool(steals) == kill, f"steals {steals} in a run {'with' if kill else 'without'}"
          " a killed host")
    survivors = [h for h, r in enumerate(results) if r is not None]
    check(survivors == list(range(MESH_HOSTS - 1 if kill else MESH_HOSTS)),
          f"surviving hosts {survivors}")
    for h in survivors:
        sigs, owners = results[h]
        for name in MESH_TYPES:
            check(sigs[name] == single[name]["sig"],
                  f"host {h}, {name}: the mesh answer differs from the single host's")
        want = list(range(MESH_HOSTS - 1)) if kill else list(range(MESH_HOSTS))
        check(owners == want, f"host {h}: ownership.hosts() is {owners}, expected {want}")
    computed = {name: sum(reads[name]) for name in MESH_TYPES}
    planned = computed["b_where_columns"] + computed["c_by_label"]
    check(counts["block_sketch"] == computed["p95"] and counts["plan_sketch"] == planned,
          f"launches {counts} for the blocks the hosts read {computed}")
    for name in MESH_TYPES:
        check(computed[name] >= single[name]["blocks_read"],
              f"{name}: the hosts read {computed[name]} blocks, the fold"
              f" {single[name]['blocks_read']}")
    for dds in hosts.values():
        dds.close()
    payloads = sum(c.payloads for c in counting)
    return {
        "wall_s": wall, "launches": counts, "blocks_read_by_hosts": reads,
        "queries_s": {name: max(e for _, e in s) - min(b for b, _ in s)
                      for name, s in spans.items()},
        "payload_bytes_per_block": sum(c.payload_bytes for c in counting) / max(payloads, 1),
        "payloads_published": payloads, "steals": steals,
    }


def mesh_child(store: str, device: str) -> dict:
    """One process of the mesh: joins through ``init_from_env()``, opens the
    store on ``device``, waits for its peers and runs the mesh queries
    through ``ds.distribute``.  The victim (``RSP_VICTIM`` names its rank)
    announces it connected and waits to be killed."""
    import os
    import signal

    from repro_torch import obs, rsp
    from repro_torch.distributed import init_from_env
    from repro_torch.kernels.block_sketch import block_sketch

    t = init_from_env()
    check(t is not None, "RSP_COORDINATOR is not set")
    victim = os.environ.get("RSP_VICTIM")
    if str(t.host_id) == victim:
        t.put(f"ready/{t.host_id}", b"1")
        signal.pause()
    ds = rsp.open(store, device=device, cache_blocks=BLOCKS)
    # only the killed run waits a short grace; a mesh with no death waits
    # as long as a child may run
    dds = ds.distribute(t, straggler_grace=MESH_CHILD_TIMEOUT if victim is None else MESH_GRACE)
    # start together, the card warmed: a peer still starting up must not
    # look like a straggler
    block_sketch(dds.executor.fetch(dds.owned_blocks[0]), bins=0)
    t.put(f"start/{t.host_id}", b"1")
    for h in range(t.num_hosts):
        if str(h) != victim:
            check(t.get(f"start/{h}", MESH_CHILD_TIMEOUT) is not None, f"host {h} never started")
    out = {"host": t.host_id, "owned": len(dds.owned_blocks), "sigs": {}, "seconds": {}}
    obs.enable()   # the steal waits
    for name, (aggs, kw) in mesh_queries().items():
        t0 = time.perf_counter()
        out["sigs"][name] = result_sig(dds.query(aggs, **kw))
        out["seconds"][name] = time.perf_counter() - t0
    out["hosts"] = dds.ownership.hosts()
    out["steals"] = steal_seconds().get(t.host_id)
    out["tuner_measurements"] = tuner_measurements()
    dds.close()
    ds.close()
    return out


def run_children(argv: list[str], n: int, env: dict, *, victim: int | None = None,
                 store=None) -> list[dict]:
    """``n`` children of this script (``RSP_PROCESS_ID`` 0..n-1), each
    killed past MESH_CHILD_TIMEOUT; ``victim`` is SIGKILLed once it has put
    ``ready/<victim>`` in ``store``.  Returns each surviving child's last
    stdout line as JSON; any other outcome fails the phase."""
    import os
    import signal

    procs, files = [], []
    for rank in range(n):
        penv = dict(os.environ, **env, RSP_PROCESS_ID=str(rank), RSP_NUM_PROCESSES=str(n))
        if victim is not None:
            penv["RSP_VICTIM"] = str(victim)
        # files, not pipes: a child never blocks on a full pipe nobody reads
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        files.append((out, err))
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *argv],
                                      env=penv, stdout=out, stderr=err, text=True))
    t0 = time.perf_counter()
    killed = None
    try:
        while any(p.poll() is None for p in procs):
            if (victim is not None and killed is None and procs[victim].poll() is None
                    and store.check([f"ready/{victim}"])):
                procs[victim].send_signal(signal.SIGKILL)
                killed = time.perf_counter() - t0
            check(time.perf_counter() - t0 < MESH_CHILD_TIMEOUT,
                  f"a child of {argv[0]} ran past {MESH_CHILD_TIMEOUT} s")
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
            out.close()
            err.close()
    got = []
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        if rank == victim:
            check(killed is not None, f"the victim exited with {p.returncode} before its kill")
            continue
        check(p.returncode == 0,
              f"{argv[0]} child {rank} exited {p.returncode}: {stderr[-2000:]}")
        got.append(json.loads(stdout.strip().splitlines()[-1]))
    return got


def mesh_processes(store: str, device, single: dict, *, kill: bool) -> dict:
    """The mesh as processes on the card, over a ``TCPStore`` this process
    hosts: four children, or three with the last SIGKILLed once it has
    connected.  Every survivor's answers must equal the single host's."""
    from repro_torch.distributed import serve_store

    server = serve_store()
    n = MESH_HOSTS - 1 if kill else MESH_HOSTS
    t0 = time.perf_counter()
    got = run_children(["--mesh-child", store, str(device)], n,
                       {"RSP_COORDINATOR": f"127.0.0.1:{server.port}"},
                       victim=n - 1 if kill else None, store=server)
    wall = time.perf_counter() - t0
    del server
    for child in got:
        for name in MESH_TYPES:
            check(child["sigs"][name] == single[name]["sig"],
                  f"process {child['host']}, {name}: the mesh answer differs from the"
                  " single host's")
        want = list(range(n - 1)) if kill else list(range(n))
        check(child["hosts"] == want, f"process {child['host']}: hosts {child['hosts']}")
        check(child["tuner_measurements"] == 0,
              f"process {child['host']}: the tuner measured {child['tuner_measurements']} keys"
              " (the launcher's cache file should have held them)")
    steals = {c["host"]: c["steals"] for c in got if c["steals"]}
    check(bool(steals) == kill, f"steals {steals} in a run {'with' if kill else 'without'}"
          " a killed process")
    return {"processes": n, "killed": kill, "wall_s": wall,
            "queries_s": {name: max(c["seconds"][name] for c in got) for name in MESH_TYPES},
            "steals": steals}


def partition_child(npy: str, seed: int, device: str) -> dict:
    """Rank ``RSP_PROCESS_ID`` of a gloo group that meets on the parent's
    ``TCPStore`` at ``RSP_STORE``: maps its original block (rows ``[i*N/D,
    (i+1)*N/D)``) of the corpus, moves it to the card and runs
    ``distributed_rsp_partition`` (one rsp_shuffle launch, the exchange
    through host memory); then holds the shuffle of the same block against
    its plain gather on the card, bit for bit, and times both with CUDA
    events beside the shuffle's bytes bound."""
    import hashlib
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels, obs
    from repro_torch.core import distributed_rsp_partition
    from repro_torch.kernels.rsp_shuffle import (make_permutations, rsp_shuffle,
                                                 rsp_shuffle_plain, shuffle_path)

    rank, d = int(os.environ["RSP_PROCESS_ID"]), int(os.environ["RSP_NUM_PROCESSES"])
    host, port = os.environ["RSP_STORE"].rsplit(":", 1)
    dist.init_process_group("gloo", store=dist.TCPStore(host, int(port), is_master=False),
                            rank=rank, world_size=d)
    corpus = np.load(npy, mmap_mode="r")
    n = corpus.shape[0] // d
    shard = torch.from_numpy(np.ascontiguousarray(corpus[rank * n:(rank + 1) * n])).to(device)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    dist.barrier()
    obs.enable()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    block = distributed_rsp_partition(shard, seed)
    sync()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()["rsp_shuffle"]   # the partition's path ends here
    exchange = [e["dur"] / 1e6 for e in obs.get_tracer().chrome_events()
                if e.get("name") == "partition.exchange"]
    obs.disable()
    sha = hashlib.sha256(block.cpu().numpy().tobytes()).hexdigest()
    tp, ip = (torch.from_numpy(a).to(dev) for a in make_permutations(seed, rank, d, n // d))
    # the kernel at this path's shape (the rows path, its tiles dealt over
    # gridDim.z) against the plain gather, on the same block and permutations
    shuffled = rsp_shuffle(shard, tp, ip, tile_rows=n // d)
    plain = rsp_shuffle_plain(shard, tp, ip, tile_rows=n // d)
    check(torch.equal(shuffled, plain),
          f"rank {rank}: rsp_shuffle differs from its plain gather in"
          f" {int((shuffled != plain).any(dim=1).sum())} rows")
    del shuffled, plain
    shuffle_ms = (time_cuda(lambda i: rsp_shuffle(shard, tp, ip, tile_rows=n // d), reps=5)
                  if dev.type == "cuda" else None)
    plain_ms = (time_cuda(lambda i: rsp_shuffle_plain(shard, tp, ip, tile_rows=n // d), reps=5)
                if dev.type == "cuda" else None)
    # the shuffle reads the block and its permutations once and writes the block once
    shuffle_bound_ms, by = bound_ms(2 * shard.numel() * 4 + (tp.numel() + ip.numel()) * 4, 0)
    dist.barrier()
    dist.destroy_process_group()
    return {"rank": rank, "rows": n, "sha256": sha, "launches": launches, "total_s": total,
            "exchange_s": exchange[0] if exchange else None, "shuffle_ms": shuffle_ms,
            "shuffle_plain_ms": plain_ms, "shuffle_bound_ms": shuffle_bound_ms,
            "shuffle_bound_by": by,
            "shuffle_path": shuffle_path(n // d, shard.shape[1] * 4)}


def collective_partition(args, npy: str, device) -> dict:
    """Four gloo ranks on the card, meeting on a ``TCPStore`` this process
    hosts, each randomizing one original block of the corpus: rank k's
    block must equal block k of the ``cuda`` backend's partition of the
    whole corpus (P = K = 4) bit for bit, with one rsp_shuffle launch a
    rank; and that backend's blocks must equal the plain gather's on the
    card (each original block gathered by the same permutations, the
    sub-blocks transposed), so the kernel is never held against itself."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch import rsp
    from repro_torch.distributed import serve_store
    from repro_torch.kernels.rsp_shuffle import make_permutations, rsp_shuffle_plain

    server = serve_store()
    t0 = time.perf_counter()
    got = run_children(["--partition-child", npy, str(device), "--seed", str(args.seed)],
                       MESH_HOSTS, {"RSP_STORE": f"127.0.0.1:{server.port}"})
    wall = time.perf_counter() - t0
    del server
    corpus = np.load(npy, mmap_mode="r")
    d, n = MESH_HOSTS, corpus.shape[0] // MESH_HOSTS
    ds = rsp.partition(corpus, blocks=d, original_blocks=d, seed=args.seed, backend="cuda",
                       summaries=False, device=device)
    want = [hashlib.sha256(ds.block(k).cpu().numpy().tobytes()).hexdigest() for k in range(d)]
    ds.close()
    subs = []
    for i in range(d):
        x = torch.from_numpy(np.ascontiguousarray(corpus[i * n:(i + 1) * n])).to(device)
        tp, ip = (torch.from_numpy(a).to(device)
                  for a in make_permutations(args.seed, i, d, n // d))
        subs.append(rsp_shuffle_plain(x, tp, ip, tile_rows=n // d).reshape(d, n // d, -1))
    plain = [hashlib.sha256(torch.cat([s[k] for s in subs]).cpu().numpy().tobytes()).hexdigest()
             for k in range(d)]
    del subs
    check(want == plain, "the cuda backend's blocks differ from the plain gather's on the card")
    for child in sorted(got, key=lambda c: c["rank"]):
        check(child["sha256"] == want[child["rank"]],
              f"rank {child['rank']}'s block differs from block {child['rank']} of the cuda"
              " backend's partition")
        check(child["launches"] == 1, f"rank {child['rank']} launched rsp_shuffle"
              f" {child['launches']} times")
    return {"wall_s": wall, "ranks": sorted(got, key=lambda c: c["rank"]),
            "launches": sum(c["launches"] for c in got)}


def mesh(args, tmp: str, device) -> dict:
    """Phase 3f on the ingested store and its ``.npy``: (a) four
    ``LocalTransport`` hosts on threads, (b) the same with host 3 killed,
    (c) four processes over a ``TCPStore``, then three with the last
    SIGKILLed, (d) the collective partition over four gloo ranks."""
    import torch

    from repro_torch import rsp

    store, npy = str(Path(tmp) / "ingested.rsp"), str(Path(tmp) / "corpus.npy")
    t_phase = time.perf_counter()
    ds = rsp.open(store, device=device, cache_blocks=BLOCKS)
    single = {}
    for name, (aggs, kw) in mesh_queries().items():
        ds.query(aggs, **kw)   # warm the plan cache and the grid tensors
        # timed on a fresh block cache, as each mesh host starts
        cold = rsp.open(store, device=device, cache_blocks=BLOCKS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cold.query(aggs, **kw)
        single[name] = {"sig": result_sig(r), "blocks_read": r.blocks_read,
                        "seconds": time.perf_counter() - t0}
        cold.close()
    out = {"single": {k: {"seconds": v["seconds"], "blocks_read": v["blocks_read"]}
                      for k, v in single.items()}}
    for tag, kill in (("threads", False), ("threads_killed", True)):
        t0 = time.perf_counter()
        out[tag] = mesh_threads(ds, single, kill=kill)
        phase(f"mesh {tag}", t0, " ".join(
            f"{name} {out[tag]['queries_s'][name]:.3f} s (single host"
            f" {single[name]['seconds']:.3f} s)" for name in MESH_TYPES)
            + f"; payload {out[tag]['payload_bytes_per_block']:.0f} B a block;"
            f" launches {json.dumps(out[tag]['launches'])}")
    ds.close()
    # host 3 dies in the first query; the survivors re-deal its blocks after
    # it, so only the first query waits out the grace.  The steal time is
    # the longest wait, in the killed run itself, from a survivor's first
    # look for a payload to its re-deal
    first = MESH_TYPES[0]
    out["steal_s"] = max(v["seconds"] / v["steals"]
                         for v in out["threads_killed"]["steals"].values())
    for tag, kill in (("processes", False), ("processes_killed", True)):
        t0 = time.perf_counter()
        out[tag] = mesh_processes(store, device, single, kill=kill)
        phase(f"mesh {tag}", t0, json.dumps(out[tag]))
    t0 = time.perf_counter()
    out["partition"] = collective_partition(args, npy, device)
    phase("mesh partition", t0, json.dumps(out["partition"]))
    out["seconds"] = time.perf_counter() - t_phase
    phase("mesh", t_phase, f"steal {out['steal_s']:.4f} s on threads (query {first}, host 3"
          f" killed, grace {MESH_GRACE} s); on processes"
          f" {json.dumps(out['processes_killed']['steals'])}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------

def times(args, device) -> dict:
    import torch

    from repro_torch.kernels import block_sketch as bsk
    from repro_torch.kernels import plan as plk
    from repro_torch.kernels.block_sketch.kernel import block_sketch_packed, block_sketch_plain
    from repro_torch.kernels.block_sketch.ops import grid_tensors
    from repro_torch.kernels.plan import PlanArrays, QueryPlan
    from repro_torch.kernels.plan.kernel import plan_sketch_packed, plan_sketch_plain
    from repro_torch.kernels.block_sketch import ops as bs_ops
    from repro_torch.kernels.plan import ops as plan_ops
    from repro_torch.kernels.rsp_shuffle import (
        flat_gather_index, partition_permutations, rsp_shuffle_cuda, rsp_shuffle_plain,
        shuffle_path)
    from repro_torch.kernels.rsp_shuffle import ops as rs_ops

    P = K = BLOCKS
    R = args.records // P
    delta = R // K
    n = args.records // K
    F = 29
    out = {}
    x = torch.randn((P, R, F), device=device)
    tp, ip = (torch.from_numpy(a).to(device) for a in partition_permutations(args.seed, P, K, delta))
    flat = flat_gather_index(tp, ip, delta)
    xf = x.reshape(P * R, F)
    nbytes = 2 * x.numel() * 4 + tp.numel() * 4 + ip.numel() * 4
    b, by = bound_ms(nbytes, 0)
    # the staged kernel at the HIGGS tile (1100 x 116 B), the row kernel at
    # --records 1100000's (110 x 116 B)
    path = shuffle_path(delta, F * 4, x_ptr=x.data_ptr())
    tuned = rs_ops.shuffle_config(x, tp, ip, delta)   # the tuner's winner, cached
    out["rsp_shuffle"] = {
        **time_turns({"ms": lambda i: rsp_shuffle_cuda(x, tp, ip, tile_rows=delta),
                      "tuned_ms": lambda i: rsp_shuffle_cuda(x, tp, ip, tile_rows=delta,
                                                             path=tuned.get("path"),
                                                             threads=tuned.get("threads"))},
                     reps=5),
        "tuned_config": tuned.label,
        "plain_ms": time_cuda(lambda i: rsp_shuffle_plain(x, tp, ip, tile_rows=delta), reps=5),
        "library_ms": time_cuda(lambda i: xf.index_select(0, flat), reps=5),
        "device_ms": device_ms(lambda i: rsp_shuffle_cuda(x, tp, ip, tile_rows=delta), 5,
                               f"rsp_shuffle_{path}"),
        "bound_ms": b, "bound_by": by,
        "shape": f"[{P}, {R}, {F}] f32, tile {delta}, one launch, {path} kernel",
    }
    del x, xf, flat, tp, ip

    blk = make_block(n, args.seed + 2, device)
    # the timed loops cycle through 8 blocks (102 MB, twice the L2), so a
    # block is not in L2 when a call reads it
    blks = [blk] + [make_block(n, args.seed + 3 + i, device) for i in range(7)]
    glo, ghi = grid_of(blk)
    lo, invw = grid_tensors(glo, ghi, BINS, device)
    nbytes = blk.numel() * 4 + 2 * F * 4 + 5 * F * 4 + F * BINS * 8
    b, by = bound_ms(nbytes, 10 * blk.numel())
    # the launchers the query path calls: one launch, the packed output
    tuned = bs_ops.sketch_config(blk, lo, invw, bins=BINS)
    out["block_sketch"] = {
        **time_turns({"ms": lambda i: block_sketch_packed(blks[i % 8], lo, invw, bins=BINS),
                      "tuned_ms": lambda i: block_sketch_packed(blks[i % 8], lo, invw, bins=BINS,
                                                                config=tuned)}, reps=REPS),
        "tuned_config": bs_ops.as_candidate(tuned).label,
        "plain_ms": time_cuda(lambda i: block_sketch_plain(blks[i % 8], lo, invw, bins=BINS),
                              reps=REPS),
        "device_ms": device_ms(
            lambda i: block_sketch_packed(blks[i % 8], lo, invw, bins=BINS), REPS, *bsk.KERNELS),
        "library_ms": None, "bound_ms": b, "bound_by": by,
        "shape": f"[{n}, {F}] f32, bins {BINS}", "kernels_per_call": len(bsk.KERNELS),
        "launch": bsk.LAUNCHES.last,
    }
    one_kernel("block_sketch", out["block_sketch"]["device_ms"])

    def plan_times(plan, shape):
        """Times and bound of one plan on the rotating blocks, bins 0 (the
        main path's queries ask for means only).  The bound reads the
        sectors of the columns the plan touches and writes its outputs."""
        arrays = PlanArrays.build(plan, F, device)
        fp, g = arrays.cols.numel(), arrays.groups
        tuned = plan_ops.plan_config(plan, blk, None, None, bins=0)
        t_arrays = PlanArrays.build(plan, F, device, path=tuned.get("path"))
        t_config = plan_ops.as_config(tuned)
        read = sector_bytes(n, F, arrays.touched)
        nbytes = read + arrays.pcol.numel() * 12 + fp * 4 + 5 * g * fp * 4 + 4
        b, by = bound_ms(nbytes, (len(plan.predicates) + 5 * fp) * n)
        return {
            **time_turns({"ms": lambda i: plan_sketch_packed(blks[i % 8], arrays, None, None,
                                                             bins=0),
                          "tuned_ms": lambda i: plan_sketch_packed(blks[i % 8], t_arrays, None,
                                                                   None, bins=0, config=t_config)},
                         reps=REPS),
            "tuned_config": tuned.label,
            "plain_ms": time_cuda(
                lambda i: plan_sketch_plain(blks[i % 8], plan, None, None, bins=0), reps=REPS),
            "device_ms": device_ms(
                lambda i: plan_sketch_packed(blks[i % 8], arrays, None, None, bins=0), REPS,
                *plk.KERNELS),
            "library_ms": None, "bound_ms": b, "bound_by": by, "bound_read_bytes": read,
            "shape": f"{shape}, {arrays.path} path", "kernels_per_call": len(plk.KERNELS),
            "launch": plk.LAUNCHES.last,
        }

    # query (c)'s plan carries 300 of the main path's 333 plan launches: the
    # per-class mean, G = 2 over all 29 columns
    out["plan_sketch"] = plan_times(QueryPlan(group_by=28, num_classes=2),
                                    f"[{n}, {F}] f32, group_by c28, G 2, all columns, bins 0")
    one_kernel("plan_sketch", out["plan_sketch"]["device_ms"])
    # query (b)'s plan: predicate c0 > 0.5, columns (0, 28); two columns'
    # sectors are about a third of the block
    where = plan_times(QueryPlan(predicates="c0 > 0.5", columns=(0, 28)),
                       f"[{n}, {F}] f32, where c0 > 0.5, columns (0, 28), bins 0")
    one_kernel("plan_sketch, query (b)'s plan", where["device_ms"])
    print(f"plan_sketch, query (b)'s plan: {json.dumps(where)}", flush=True)
    out["plan_sketch_where"] = where
    return out


def one_kernel(name: str, dm: dict) -> None:
    """A sketch call launches its one kernel and nothing beside it."""
    check(dm["ms"] is not None, f"{name}: the profiler missed a launch ({dm['seen']})")
    check(dm["others"] == 0, f"{name}: {dm['others']} device events beside the kernel in"
          f" {dm['launched']} calls (a memset, a cast or a second kernel)")


# ---------------------------------------------------------------------------
# Dense LM serving: the flash attention kernel, llama3.2-1b at full width
# ---------------------------------------------------------------------------

LM_ARCH = "llama3.2-1b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 64
ENS_K, ENS_BATCH, ENS_PROMPT, ENS_NEW = 3, 4, 512, 32
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}    # tests/test_kernels.py:53
# teacher-forced logits against the served ones: the reference's own
# decode-vs-forward tolerance (tests/test_models_smoke.py), |a - b| <= 8e-2 (1 + |b|)
TF_TOL = 8e-2
# zamba2-7b's logits are ~1 (llama3.2-1b's ~45), so TF_TOL (1 + |b|) is ~0.1
# there, and 95 blocks of bf16 rounding carry float32-level differences to
# rare logits beyond it.  The hybrid's check allows these shares of them, set
# just above what runs with no kernel at all put beyond it on the H100: 2 of
# 8.19M served logits (served through the plain versions) and 0 of 532M
# every-position ones (the plain scan at chunk 64 against 128); the sound run
# had 1 and 7.  The SSD controls stay inside these shares too: the
# layer-by-layer check is what refuses them.
TF_RATE = {"served": 3e-7, "sequence": 3e-8}
FLASH_CASES = {
    # name: (B, H, Hkv, S, D, causal, strided as the serve path lays it out)
    "llama3.2-1b prefill": (8, 32, 8, 2048, 64, True, True),
    "qwen2-0.5b heads": (2, 14, 2, 1024, 64, True, False),
    "qwen3-14b heads": (2, 40, 8, 1024, 128, True, False),
    "granite-20b MQA": (2, 48, 1, 1024, 128, True, False),
    "ragged S": (2, 32, 8, 1000, 64, True, True),
    "non-causal": (4, 32, 8, 512, 128, False, False),
    "zamba2-7b shared block": (8, 32, 32, 2048, 112, True, True),
    "hubert-xlarge encoder": (8, 16, 16, 2048, 80, False, True),
}
# a smoke config's attention (head dim 16), run through impl="auto": B, H, Hkv, S, D
FLASH_SMOKE = (2, 4, 2, 300, 16)


def flash_inputs(B, H, Hkv, S, D, dtype, device, seed, strided):
    """q [B, H, S, D] and k, v [B, Hkv, S, D]; ``strided`` lays them out as
    the attention layer hands them over: views of [B, S, heads, D]."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def make(h):
        if strided:
            return torch.randn((B, S, h, D), generator=g, device=device).to(dtype).transpose(1, 2)
        return torch.randn((B, h, S, D), generator=g, device=device).to(dtype)

    return make(H), make(Hkv), make(Hkv)


def flash_parity(args, device) -> float:
    """The flash kernel against its plain version at every case, in bf16 and
    float32; returns the largest absolute deviation."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    worst = 0.0
    for i, (name, (B, H, Hkv, S, D, causal, strided)) in enumerate(FLASH_CASES.items()):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(B, H, Hkv, S, D, dtype, device, args.seed + i, strided)
            got = flash_attention_cuda(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            diff = (got.float() - want.float()).abs()
            bad = diff > tol + tol * want.float().abs()
            check(got.shape == want.shape and got.dtype == dtype, f"flash {name}: shape/dtype")
            check(bool(torch.isfinite(got).all()), f"flash {name} {dtype}: non-finite output")
            check(not bool(bad.any()), f"flash {name} {dtype}: {int(bad.sum())} values beyond"
                  f" {tol} (largest deviation {float(diff.max()):.3g})")
            worst = max(worst, float(diff.max()))
            print(f"  flash {name} {str(dtype).split('.')[1]}: max |kernel - plain|"
                  f" {float(diff.max()):.3g} (tolerance {tol})", flush=True)
            del q, k, v, got, want, diff, bad
    # a smoke config's head dim through auto, which pads D to the kernel's 64
    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32):
        B, H, Hkv, S, D = FLASH_SMOKE
        q, k, v = flash_inputs(B, H, Hkv, S, D, dtype, device, args.seed + 50, True)
        before = fa.LAUNCHES.value
        got = fa.flash_attention(q, k, v, causal=True, impl="auto")
        check(fa.LAUNCHES.value == before + 1, "flash at D = 16: auto did not launch the kernel")
        want = flash_attention_plain(q, k, v, causal=True)
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        diff = (got.float() - want.float()).abs()
        bad = int((diff > tol + tol * want.float().abs()).sum())
        check(got.shape == want.shape and bad == 0,
              f"flash at D = 16 {dtype}: {bad} values beyond {tol} (largest {float(diff.max()):.3g})")
        worst = max(worst, float(diff.max()))
        print(f"  flash smoke D = 16 through auto {str(dtype).split('.')[1]}: max |kernel -"
              f" plain| {float(diff.max()):.3g} (tolerance {tol})", flush=True)
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# The zamba2 hybrid: the mamba2_ssd kernel, zamba2-7b at full width
# ---------------------------------------------------------------------------

HYBRID_ARCH = "zamba2-7b"
HY_BATCH, HY_PROMPT, HY_NEW = 8, 2048, 32
SSD_TOL = 2e-4    # tests/test_kernels.py:122, held as |a - b| <= tol (1 + |b|)
SSD_CASES = {
    # name: (B, L, H, decay, h0); P = N = 64, the kernel's chunk 128
    "zamba2-7b prefill": (8, 2048, 112, "softplus", False),
    "weak decay, dA in [-1e-3, 0]": (2, 2048, 112, "weak", False),
    "strong decay, dA = -30": (2, 1024, 112, "strong", False),
    "ragged L = 2080, from h0": (2, 2080, 112, "softplus", True),
    "B = 1": (1, 2048, 112, "softplus", False),
}
# zamba2's smoke config (SSM head and state 16, chunk 8) through impl="auto":
# B, L, H, P, N
SSD_SMOKE = (2, 300, 8, 16, 16)


def ssd_inputs(B, L, H, decay, device, seed, with_h0=False):
    """xbar [B, L, H, 64], dA [B, L, H] (<= 0), B and C [B, L, 64] and,
    with ``with_h0``, h0 [B, H, 64, 64], float32 on the card."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, L, H, 64), generator=g, device=device)
    if decay == "weak":
        # the state sums L nearly undecayed steps: xbar / sqrt(L) keeps it
        # O(1), as in the reference's own cases (tests/test_kernels.py); at
        # unit scale y reaches ~1e3 by cancellation, where any two float32
        # scans differ by more than the absolute 2e-4 (both the kernel and
        # the plain version are 3e-4 to 5e-4 from a float64 recurrence)
        x = x * L ** -0.5
        dA = -1e-3 * torch.rand((B, L, H), generator=g, device=device)
    elif decay == "strong":
        dA = torch.full((B, L, H), -30.0, device=device)
    else:   # the served model's scale: -softplus(normal)
        dA = -torch.nn.functional.softplus(torch.randn((B, L, H), generator=g, device=device))
    Bm = torch.randn((B, L, 64), generator=g, device=device)
    Cm = torch.randn((B, L, 64), generator=g, device=device)
    h0 = torch.randn((B, H, 64, 64), generator=g, device=device) if with_h0 else None
    return (x, dA, Bm, Cm), h0


def ssd_parity(args, device) -> float:
    """The SSD kernel (through ``ops.ssd``, which pads a ragged L) against
    its plain chunked version at every case, y and h_final; returns the
    largest absolute deviation."""
    import torch

    from repro_torch.kernels.mamba2_ssd import ssd

    worst = 0.0
    for i, (name, (B, L, H, decay, with_h0)) in enumerate(SSD_CASES.items()):
        arrays, h0 = ssd_inputs(B, L, H, decay, device, args.seed + 100 + i, with_h0)
        got = ssd(*arrays, chunk=128, h0=h0, impl="cuda")
        want = ssd(*arrays, chunk=128, h0=h0, impl="torch")
        torch.cuda.synchronize()
        for part, a, b in (("y", got[0], want[0]), ("h_final", got[1], want[1])):
            check(a.shape == b.shape, f"ssd {name} {part}: shape {tuple(a.shape)}")
            check(bool(torch.isfinite(a).all()), f"ssd {name} {part}: non-finite output")
            diff = (a - b).abs()
            bad = int((diff > SSD_TOL * (1 + b.abs())).sum())
            check(bad == 0, f"ssd {name} {part}: {bad} values beyond {SSD_TOL} (1 + |b|)"
                  f" (largest deviation {float(diff.max()):.3g})")
            worst = max(worst, float(diff.max()))
            print(f"  ssd {name} {part}: max |kernel - plain| {float(diff.max()):.3g},"
                  f" max |plain| {float(b.abs().max()):.3g}", flush=True)
        if decay == "weak":
            # the case has the power to see a scan that drops the carry
            cut, _ = _no_carry(*arrays, 128, None)
            far = int(((cut - want[0]).abs() > SSD_TOL * (1 + want[0].abs())).sum())
            print(f"  ssd {name}: the state not carried across chunks puts {far} of"
                  f" {cut.numel()} values of y beyond the tolerance", flush=True)
            check(far > 0, f"ssd {name}: a scan without the inter-chunk carry passes")
            del cut
        del arrays, h0, got, want
    # zamba2's smoke config (P = N = 16, chunk 8) through auto, which pads P
    # and N to 64 and runs the kernel at its chunk of 128
    from repro_torch.kernels import mamba2_ssd

    g = torch.Generator(device=device).manual_seed(args.seed + 150)
    B, L, H, P, N = SSD_SMOKE
    x = torch.randn((B, L, H, P), generator=g, device=device)
    dA = -torch.nn.functional.softplus(torch.randn((B, L, H), generator=g, device=device))
    Bm, Cm = (torch.randn((B, L, N), generator=g, device=device) for _ in range(2))
    h0 = torch.randn((B, H, P, N), generator=g, device=device)
    before = mamba2_ssd.LAUNCHES.value
    got = ssd(x, dA, Bm, Cm, chunk=8, h0=h0, impl="auto")
    check(mamba2_ssd.LAUNCHES.value == before + 1, "ssd at P = N = 16: auto did not launch")
    want = ssd(x, dA, Bm, Cm, chunk=8, h0=h0, impl="torch")
    for part, a, b in (("y", got[0], want[0]), ("h_final", got[1], want[1])):
        diff = (a - b).abs()
        bad = int((diff > SSD_TOL * (1 + b.abs())).sum())
        check(a.shape == b.shape and bad == 0, f"ssd smoke {part}: {bad} values beyond"
              f" {SSD_TOL} (1 + |b|) (largest deviation {float(diff.max()):.3g})")
        worst = max(worst, float(diff.max()))
        print(f"  ssd smoke P = N = 16, chunk 8 through auto, from h0, {part}: max |kernel -"
              f" plain| {float(diff.max()):.3g}", flush=True)
    torch.cuda.empty_cache()
    return worst


def ssd_work(B, L, H, P=64, N=64, Q=128) -> tuple[int, int]:
    """(operations, bytes) of one SSD scan: per batch row and chunk C B^T's
    causal half (B and C are shared by all heads), then per chunk and head
    the causal half of the intra-chunk product, the inter-chunk term and the
    state update (2 operations a multiply-add); xbar, dA, B and C read once,
    y and h_final written once."""
    nc = -(-L // Q)
    tri = Q * (Q + 1) // 2
    per_head = tri * P + Q * N * P + Q * P * N
    ops = 2 * B * nc * (tri * N + H * per_head)
    nbytes = 4 * (2 * B * L * H * P + B * L * H + 2 * B * L * N + B * H * P * N)
    return ops, nbytes


def prefill_flops(cfg, batch: int, seq: int) -> int:
    """Operations of a prefill to last-position logits: every projection
    (2 per multiply-add) over every token, causal attention over the
    prompt's pairs, and the last position's unembedding."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    proj = d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = (2 if cfg.mlp_type == "gelu" else 3) * d * cfg.d_ff
    attn = 4 * cfg.num_heads * dh * seq * (seq + 1) // 2 * batch
    return cfg.num_layers * (2 * (proj + mlp) * batch * seq + attn) + 2 * batch * d * cfg.vocab_size


def logit_deviation(got, want) -> dict:
    """Logits held against the plain attention's: how many lie beyond
    TF_TOL (1 + |b|), the largest |a - b| and the argmax agreement."""
    diff = (got.float() - want.float()).abs()
    bad = int((diff > TF_TOL * (1 + want.float().abs())).sum())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return {"bad": bad, "max_abs_err": float(diff.max()), "argmax_agreement": same,
            "logits": diff.numel()}


def _combined(parts: list[dict]) -> dict:
    """``logit_deviation``s of the chunks of one comparison, combined."""
    n = sum(p["logits"] for p in parts)
    return {"bad": sum(p["bad"] for p in parts),
            "max_abs_err": max(p["max_abs_err"] for p in parts),
            "argmax_agreement": sum(p["argmax_agreement"] * p["logits"] for p in parts) / n,
            "logits": n}


def compare_hidden(model, h_a, h_b, chunk: int = 256) -> dict:
    """The logits of hidden states ``h_a`` against those of ``h_b`` at every
    position, ``chunk`` positions at a time, as ``logit_deviation`` counts
    them."""
    return _combined([
        logit_deviation(model.logits(h_a[:, i:i + chunk]), model.logits(h_b[:, i:i + chunk]))
        for i in range(0, h_a.shape[1], chunk)])


def teacher_forced(model, tokens, step_logits, plain: dict | None = None) -> dict:
    """The served sequence ``tokens`` [B, P + new] fed through ``model``
    with the plain versions of its kernels on the card (``plain``: the
    ``hidden`` arguments that select them; the attention's by default).  ``served``: its logits at
    positions P-1 .. P+new-2 against ``step_logits``, the ones that chose
    the new tokens.  ``sequence``: its logits at every position against the
    same sequence through the model's own attention (the kernel on the
    card) -- early positions attend to a few keys, where attention carries
    a large share of the residual stream; at the last positions it
    averages some 2,000 near-uniform keys and moves the logits little."""
    import torch

    seq = torch.as_tensor(tokens, device=step_logits.device, dtype=torch.int64)[:, :-1]
    start = seq.shape[1] - step_logits.shape[1] + 1
    with torch.no_grad():
        h_plain, _ = model.hidden(seq, **(plain or {"attn_impl": "torch"}))
        h_model, _ = model.hidden(seq)
        served = logit_deviation(model.logits(h_plain[:, start - 1:]), step_logits)
        sequence = compare_hidden(model, h_model, h_plain)
    return {"served": served, "sequence": sequence}


@contextlib.contextmanager
def attention_replaced(stand_in):
    """Serve with ``stand_in(q, k, v, causal)`` in place of the flash
    kernel; the plain attention (``impl="torch"``) stays the yardstick."""
    from repro_torch.models import attention

    real = attention.flash_attention

    def patched(q, k, v, *, causal, impl="auto", **kw):
        return real(q, k, v, causal=causal, impl=impl, **kw) if impl == "torch" else stand_in(
            q, k, v, causal)

    attention.flash_attention = patched
    try:
        yield
    finally:
        attention.flash_attention = real


def _non_causal(q, k, v, causal):
    from repro_torch.kernels.flash_attention import flash_attention

    return flash_attention(q, k, v, causal=False, impl="cuda")


def _zero_output(q, k, v, causal):
    import torch

    return torch.zeros_like(q)


# known-wrong attentions the teacher-forced check must refuse
CONTROLS = {"non-causal": _non_causal, "zero output": _zero_output}


# new tokens of the profiled generate: the device events a decode step is a
# per-step count, and parsing a long generate's trace took most of a
# profile phase (granite-moe's: 45.6 s around a 64-token generate)
PROFILE_NEW = 8


def serve_profile(tag: str, model, server, prompts, new: int, stats: dict, peak_gb: float,
                  gpu: str, forward: bool = False) -> dict:
    """After a timed ``Server.generate`` of ``new`` tokens (its ``stats``
    and peak memory): one profiled generate of ``prompts`` and at most
    PROFILE_NEW new tokens (the device's busy time and idle share, its
    largest device items), one profiled prefill from fresh float32 caches
    (where its time goes on the device) and, with ``forward``, one profiled
    stateless forward of the prompts.  Prints the serving lines beside the
    card and returns the numbers."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.transformer import init_caches

    cfg = model.cfg
    B, P = prompts.shape
    pnew = min(new, PROFILE_NEW)
    t0 = time.perf_counter()
    wall, busy, by_name, gen_events = profiled(
        lambda: server.generate(prompts, max_new_tokens=pnew))
    idle = None if busy is None else 1 - busy / wall
    seq = torch.from_numpy(prompts).to(device=server.device, dtype=torch.int64)
    caches = init_caches(cfg, B, P + new, torch.float32, server.device)
    passes = {}
    with torch.no_grad():
        passes["prefill"] = profiled(lambda: api.make_prefill_fn(model)(caches, {"tokens": seq}))
        if forward:
            passes["forward"] = profiled(lambda: api.make_forward_fn(model)({"tokens": seq}))
    del caches, seq
    pf_events = passes["prefill"][3]
    step_events = (gen_events - pf_events) / (pnew - 1)

    def top(by: dict, n: int) -> list:
        return [(name[:60], sec) for name, sec in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    decode_tps = B * (new - 1) / stats["decode_s"]
    serve = {
        "prefill_s": stats["prefill_s"], "first_token_s": stats["first_token_s"],
        "decode_s": stats["decode_s"], "decode_tokens_per_s": decode_tps,
        "total_s": stats["total_s"], "peak_gb": peak_gb, "profiled_wall_s": wall,
        "device_busy_s": busy, "idle_share": idle, "top": top(by_name, 6),
        **{f"{name}_profile": {"wall_s": p[0], "device_busy_s": p[1], "top": top(p[2], 8)}
           for name, p in passes.items()},
        "device_events": {"generate": gen_events, "prefill": pf_events,
                          "per_decode_step": step_events}, "profiled_new_tokens": pnew,
    }
    phase(f"{tag} profile", t0, f"one profiled Server.generate of {pnew} new tokens: wall"
          f" {wall:.3f} s, device busy"
          f" {busy} s; " + "; ".join(
              f"one profiled {name}: wall {serve[f'{name}_profile']['wall_s']:.3f} s, device"
              f" busy {serve[f'{name}_profile']['device_busy_s']} s, top"
              f" {json.dumps(serve[f'{name}_profile']['top'])}" for name in passes)
          + f"; device events: generate {gen_events}, prefill {pf_events}, so"
          f" {step_events:.1f} a decode step")
    for line in (f"prefill seconds {stats['prefill_s']:.4f}",
                 f"time to first token {stats['first_token_s']:.4f} s",
                 f"decode tokens/s {decode_tps:.1f} ({B} x {new - 1} tokens"
                 f" in {stats['decode_s']:.4f} s)",
                 f"peak device memory {peak_gb:.3f} GB",
                 f"device idle share {'not measured' if idle is None else f'{idle:.4f}'}"
                 f" (busy {busy} s of {wall:.3f} s, one generate of {pnew} new tokens); top"
                 f" {json.dumps(serve['top'])}"):
        print(f"serve {cfg.name} {B} x {P} + {new}: {line} [{gpu}]", flush=True)
    return serve


def lm_serving(args, device, gpu: str) -> dict:
    """Serve llama3.2-1b at full width through Server and EnsembleServer."""
    import math

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.transformer import DenseLM, init_caches
    from repro_torch.serve import EnsembleServer, Server

    cfg = ARCHS[LM_ARCH]
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    model = DenseLM(cfg, device=device, seed=args.seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = 4 * n_params
    cache_bytes = (2 * cfg.num_layers * SERVE_BATCH * cfg.num_kv_heads
                   * (SERVE_PROMPT + SERVE_NEW) * cfg.resolved_head_dim * 4)
    phase("lm model", t0, f"{cfg.name}: {n_params:,} float32 parameters ({weight_bytes / 1e9:.3f}"
          f" GB), seed {args.seed}; float32 KV cache {cache_bytes / 1e9:.3f} GB")
    # least times: the prefill's operations at the bf16 tensor-core peak; a
    # decode step's reads of every weight and the whole cache
    pf_flops = prefill_flops(cfg, SERVE_BATCH, SERVE_PROMPT)
    pf_bound_s = pf_flops / BF16_OPS_PER_S
    step_bound_s = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S
    print(f"serve {cfg.name} bounds: prefill {pf_flops / 1e12:.2f} TFLOP, {pf_bound_s:.4f} s at"
          f" the bf16 peak; decode step {(weight_bytes + cache_bytes) / 1e9:.3f} GB,"
          f" {step_bound_s * 1e3:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, so at most"
          f" {SERVE_BATCH / step_bound_s:.0f} tokens/s", flush=True)
    server = Server(cfg, model, device=device)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), np.int32)
    # warm-up at the full prompt: cuBLAS plans and the allocator's blocks
    server.generate(prompts[::-1].copy(), max_new_tokens=2)

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    tokens, step_logits = server.generate(prompts, max_new_tokens=SERVE_NEW, return_logits=True)
    counts = kernels.launch_counts()            # the serving path ends here
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = dict(server.last_stats)
    phase("lm serve", t0, f"Server.generate {SERVE_BATCH} x {SERVE_PROMPT} + {SERVE_NEW};"
          f" launches {json.dumps(counts)}")
    check(counts["flash_attention"] == cfg.num_layers,
          f"Server.generate launched flash {counts['flash_attention']} times, not {cfg.num_layers}")
    check(tokens.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW), f"tokens {tokens.shape}")
    check(bool((tokens[:, :SERVE_PROMPT] == prompts).all()), "the prompts came back changed")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size, "token ids out of range")
    check(bool(torch.isfinite(step_logits).all()), "served logits are not finite")

    # teacher forcing: the generated sequence through the same model with
    # the plain attention, held against the served logits and against the
    # kernel's forward of every position
    t0 = time.perf_counter()
    tf = teacher_forced(model, tokens, step_logits)
    phase("lm teacher forcing", t0, f"{json.dumps(tf)} (tolerance {TF_TOL} (1 + |b|))")
    for part in ("served", "sequence"):
        check(tf[part]["bad"] == 0, f"{tf[part]['bad']} {part} logits beyond the teacher-forced"
              f" tolerance (largest deviation {tf[part]['max_abs_err']:.4g})")
    del step_logits
    # controls: the same check must refuse a served run whose prefill
    # attention is wrong
    t0 = time.perf_counter()
    controls = {}
    for name, stand_in in CONTROLS.items():
        with attention_replaced(stand_in):
            ctokens, clogits = server.generate(prompts, max_new_tokens=SERVE_NEW,
                                               return_logits=True)
            controls[name] = teacher_forced(model, ctokens, clogits)
        del clogits
        refused = controls[name]["served"]["bad"] + controls[name]["sequence"]["bad"]
        check(refused > 0, f"the teacher-forced check passed a served run with {name} attention")
    phase("lm controls", t0, json.dumps(controls))
    torch.cuda.empty_cache()

    serve = serve_profile("lm", model, server, prompts, SERVE_NEW, stats, peak_gb, gpu)
    serve.update({
        "prefill_flops": pf_flops, "prefill_bound_s": pf_bound_s, "weight_bytes": weight_bytes,
        "cache_bytes": cache_bytes, "decode_step_bound_s": step_bound_s,
        "teacher_forced": tf, "controls": controls,
    })
    del server, model
    torch.cuda.empty_cache()

    # the RSP block ensemble: k models of their own seeds
    t0 = time.perf_counter()
    models = [DenseLM(cfg, device=device, seed=args.seed + 1 + i) for i in range(ENS_K)]
    ens = EnsembleServer(cfg, models, device=device)
    eprompts = rng.integers(0, cfg.vocab_size, (ENS_BATCH, ENS_PROMPT), np.int32)
    ens.generate(eprompts[::-1].copy(), max_new_tokens=2)         # warm-up
    kernels.reset_launch_counts()
    etokens = ens.generate(eprompts, max_new_tokens=ENS_NEW)
    ecounts = kernels.launch_counts()           # the ensemble path ends here
    estats = dict(ens.last_stats)
    phase("lm ensemble", t0, f"EnsembleServer k={ENS_K} {ENS_BATCH} x {ENS_PROMPT} + {ENS_NEW};"
          f" launches {json.dumps(ecounts)}")
    check(ecounts["flash_attention"] == ENS_K * cfg.num_layers,
          f"EnsembleServer.generate launched flash {ecounts['flash_attention']} times,"
          f" not {ENS_K * cfg.num_layers}")

    # the same combination outside the server: each model fed the ensemble's
    # tokens, log-probabilities averaged here
    t0 = time.perf_counter()
    seq = torch.from_numpy(etokens).to(device=device, dtype=torch.int64)
    logprobs = []
    with torch.no_grad():
        for m in models:
            caches = init_caches(cfg, ENS_BATCH, ENS_PROMPT + ENS_NEW, torch.float32, device)
            logits, caches = api.make_prefill_fn(m)(caches, {"tokens": seq[:, :ENS_PROMPT]})
            steps = [logits[:, -1]]
            for t in range(ENS_NEW - 1):
                pos = ENS_PROMPT + t
                logits, caches = api.make_decode_fn(m)(caches, {"tokens": seq[:, pos:pos + 1]})
                steps.append(logits[:, -1])
            logprobs.append(torch.log_softmax(torch.stack(steps, 1).float(), dim=-1))
            del caches
    mean_lp = torch.logsumexp(torch.stack(logprobs), dim=0) - math.log(ENS_K)
    want = mean_lp.argmax(-1).cpu().numpy()
    same = bool((want == etokens[:, ENS_PROMPT:]).all())
    phase("lm ensemble check", t0, f"ensemble tokens equal the argmax of the {ENS_K} models'"
          f" averaged log-probabilities: {same}")
    check(same, "the ensemble's tokens differ from the averaged log-probabilities' argmax")
    ens_tps = ENS_BATCH * ENS_NEW / estats["total_s"]
    print(f"serve ensemble[{ENS_K}] {cfg.name} {ENS_BATCH} x {ENS_PROMPT} + {ENS_NEW}:"
          f" first token {estats['first_token_s']:.4f} s, {ens_tps:.1f} tok/s overall [{gpu}]",
          flush=True)
    del ens, models, logprobs, seq
    torch.cuda.empty_cache()
    return {"counts": counts, "ensemble_counts": ecounts, "serve": serve,
            "ensemble": dict(estats, tokens_per_s=ens_tps)}


def hybrid_prefill_flops(cfg, batch: int, seq: int) -> int:
    """bf16 operations of a hybrid prefill to last-position logits: every
    projection of the shared block's invocations and of the Mamba2 layers
    (the float32 dt projection included) over every token, causal attention
    over the prompt's pairs, and the last position's unembedding.  The SSD
    scans' float32 operations are counted apart (``ssd_work``)."""
    from repro_torch.models.transformer import hybrid_layout

    d, dh, m = cfg.d_model, cfg.resolved_head_dim, cfg.mamba_config()
    full, _, rem = hybrid_layout(cfg)
    inv = full + (1 if rem else 0)
    shared = 2 * d * d + d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) + 3 * d * cfg.d_ff
    mamba = d * (2 * m.d_inner + 2 * m.d_state + m.num_heads) + m.d_inner * d
    attn = 4 * cfg.num_heads * dh * seq * (seq + 1) // 2 * batch
    tokens = batch * seq
    return (inv * (2 * shared * tokens + attn) + cfg.num_layers * 2 * mamba * tokens
            + 2 * batch * d * cfg.vocab_size)


@contextlib.contextmanager
def ssd_replaced(stand_in):
    """Serve with ``stand_in(xbar, dA, Bm, Cm, chunk, h0)`` in place of the
    SSD kernel; the plain scan (``impl="torch"``) stays the yardstick."""
    from repro_torch.models import mamba2

    real = mamba2.ssd

    def patched(xbar, dA, Bm, Cm, *, chunk, h0=None, impl="auto"):
        if impl == "torch":
            return real(xbar, dA, Bm, Cm, chunk=chunk, h0=h0, impl=impl)
        return stand_in(xbar, dA, Bm, Cm, chunk, h0)

    mamba2.ssd = patched
    try:
        yield
    finally:
        mamba2.ssd = real


def _no_carry(xbar, dA, Bm, Cm, chunk, h0):
    """Every chunk from a zero state: the chunks go through the kernel as
    batch rows of their own; h_final is the last chunk's."""
    import torch.nn.functional as F

    from repro_torch.kernels.mamba2_ssd import ssd

    B, L, H, P = xbar.shape
    pad = (-L) % chunk
    padded = [F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (xbar, dA, Bm, Cm)]
    nc = (L + pad) // chunk
    rows = [t.reshape(B * nc, chunk, *t.shape[2:]).contiguous() for t in padded]
    y, h = ssd(*rows, chunk=chunk, impl="cuda")
    return y.reshape(B, L + pad, H, P)[:, :L], h.reshape(B, nc, *h.shape[1:])[:, -1]


def _zero_state(xbar, dA, Bm, Cm, chunk, h0):
    import torch

    from repro_torch.kernels.mamba2_ssd import ssd

    y, h = ssd(xbar, dA, Bm, Cm, chunk=chunk, h0=h0, impl="cuda")
    return y, torch.zeros_like(h)


LAYER_TOL = 2e-2   # bf16 outputs: tests/test_torch_models.py's tolerance, a few ulps


def _tally(out: dict, name: str, got, want, tol: float) -> None:
    diff = (got.float() - want.float()).abs()
    bad = int((diff > tol * (1 + want.float().abs())).sum())
    t = out.setdefault(name, {"bad": 0, "max_abs_err": 0.0, "values": 0, "tolerance": tol})
    t["bad"] += bad
    t["max_abs_err"] = max(t["max_abs_err"], float(diff.max()))
    t["values"] += diff.numel()


def layer_by_layer(model, tokens) -> dict:
    """Each block of the hybrid fed its input from a pass through the plain
    versions (forward pre-hooks on the blocks), and run from that input once
    through its kernels (``impl="auto"``) and once through the plain
    versions: the shared block's attention output and each Mamba2 mixer's
    output held to LAYER_TOL (1 + |b|), each mixer's final SSM state (what
    decode starts from) to SSD_TOL (1 + |b|).  Blocks see the same input on
    both sides, so no rounding is carried from one block to the next.  The
    blocks' outputs are not compared: the random model's residual stream
    grows to ~2e3 at depth, where h + z cancels to values near 0 whose
    summands' ulps are 4-8."""
    import torch

    from repro_torch.models import mamba2

    seq = torch.as_tensor(tokens, device=model.embed.table.device, dtype=torch.int64)[:, :-1]
    out: dict = {}

    def shared_block(block, args, kwargs):
        h, x_emb, positions = args[:3]
        got, want = (block.attend(h, x_emb, positions, attn_impl=impl)[1]
                     for impl in ("auto", "torch"))
        _tally(out, "shared block attention output", got, want, LAYER_TOL)

    def mamba_layer(layer, args, kwargs):
        h = args[0]
        res = {impl: layer.mix(h, mamba2.init_mamba_state(layer.mcfg, h.shape[0], torch.float32,
                                                          h.device), ssd_impl=impl)
               for impl in ("auto", "torch")}
        _tally(out, "mamba2 mixer output", res["auto"][0], res["torch"][0], LAYER_TOL)
        _tally(out, "mamba2 final state", res["auto"][1]["ssm"], res["torch"][1]["ssm"],
               SSD_TOL)

    hooks = [model.shared.register_forward_pre_hook(shared_block, with_kwargs=True)]
    hooks += [layer.register_forward_pre_hook(mamba_layer, with_kwargs=True)
              for layer in model.layers]
    try:
        with torch.no_grad():
            model.hidden(seq, attn_impl="torch", ssd_impl="torch")
    finally:
        for hook in hooks:
            hook.remove()
    return out


# known-wrong SSD scans the teacher-forced check must refuse
SSD_CONTROLS = {"state not carried across chunks": _no_carry, "h_final zeroed": _zero_state}


def hybrid_serving(args, device, gpu: str) -> dict:
    """Serve zamba2-7b at full width and depth through Server."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import HybridLM, hybrid_layout
    from repro_torch.serve import Server

    cfg = ARCHS[HYBRID_ARCH]
    m = cfg.mamba_config()
    full, _, rem = hybrid_layout(cfg)
    inv = full + (1 if rem else 0)
    rng = np.random.default_rng(args.seed + 7)
    t0 = time.perf_counter()
    model = HybridLM(cfg, device=device, seed=args.seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = 4 * n_params
    T = HY_PROMPT + HY_NEW
    kv_bytes = 2 * inv * HY_BATCH * cfg.num_kv_heads * T * cfg.resolved_head_dim * 4
    ssm_bytes = cfg.num_layers * HY_BATCH * m.num_heads * m.head_dim * m.d_state * 4
    conv_bytes = cfg.num_layers * HY_BATCH * (m.conv_kernel - 1) * (m.d_inner + 2 * m.d_state) * 4
    phase("hybrid model", t0, f"{cfg.name}: {n_params:,} float32 parameters"
          f" ({weight_bytes / 1e9:.3f} GB), seed {args.seed}; float32 KV caches of {inv}"
          f" invocations {kv_bytes / 1e9:.3f} GB, SSM states of {cfg.num_layers} layers"
          f" {ssm_bytes / 1e9:.3f} GB, conv windows {conv_bytes / 1e9:.3f} GB")
    # least times: the prefill's bf16 operations at the tensor-core peak and
    # the SSD scans' float32 operations at the FMA peak; a decode step reads
    # every weight and the KV caches, and reads and writes the states
    pf_flops = hybrid_prefill_flops(cfg, HY_BATCH, HY_PROMPT)
    ssd_ops, _ = ssd_work(HY_BATCH, HY_PROMPT, m.num_heads)
    pf_bound_s = pf_flops / BF16_OPS_PER_S + cfg.num_layers * ssd_ops / FP32_OPS_PER_S
    step_bytes = weight_bytes + kv_bytes + 2 * (ssm_bytes + conv_bytes)
    step_bound_s = step_bytes / HBM_BYTES_PER_S
    print(f"serve {cfg.name} bounds: prefill {pf_flops / 1e12:.2f} TFLOP bf16"
          f" ({pf_flops / BF16_OPS_PER_S:.4f} s at the bf16 peak) and"
          f" {cfg.num_layers} x {ssd_ops / 1e9:.2f} GFLOP float32 SSD"
          f" ({cfg.num_layers * ssd_ops / FP32_OPS_PER_S:.4f} s), {pf_bound_s:.4f} s in all;"
          f" decode step {step_bytes / 1e9:.3f} GB, {step_bound_s * 1e3:.3f} ms at"
          f" {HBM_BYTES_PER_S / 1e12} TB/s, so at most {HY_BATCH / step_bound_s:.0f} tokens/s",
          flush=True)
    server = Server(cfg, model, device=device)
    prompts = rng.integers(0, cfg.vocab_size, (HY_BATCH, HY_PROMPT), np.int32)
    server.generate(prompts[::-1].copy(), max_new_tokens=2)      # warm-up at the full prompt

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    tokens, step_logits = server.generate(prompts, max_new_tokens=HY_NEW, return_logits=True)
    counts = kernels.launch_counts()            # the hybrid serving path ends here
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = dict(server.last_stats)
    phase("hybrid serve", t0, f"Server.generate {HY_BATCH} x {HY_PROMPT} + {HY_NEW};"
          f" launches {json.dumps(counts)}")
    check(counts["mamba2_ssd"] == cfg.num_layers,
          f"Server.generate launched mamba2_ssd {counts['mamba2_ssd']} times, not"
          f" {cfg.num_layers}")
    check(counts["flash_attention"] == inv,
          f"Server.generate launched flash {counts['flash_attention']} times, not {inv}")
    check(tokens.shape == (HY_BATCH, HY_PROMPT + HY_NEW), f"tokens {tokens.shape}")
    check(bool((tokens[:, :HY_PROMPT] == prompts).all()), "the prompts came back changed")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size, "token ids out of range")
    check(bool(torch.isfinite(step_logits).all()), "served logits are not finite")

    plain = {"attn_impl": "torch", "ssd_impl": "torch"}
    t0 = time.perf_counter()
    tf = teacher_forced(model, tokens, step_logits, plain=plain)
    phase("hybrid teacher forcing", t0, f"{json.dumps(tf)} (tolerance {TF_TOL} (1 + |b|))")
    del step_logits
    t0 = time.perf_counter()
    layers = layer_by_layer(model, tokens)
    phase("hybrid layer by layer", t0, json.dumps(layers))
    for part in ("served", "sequence"):
        check(tf[part]["bad"] <= TF_RATE[part] * tf[part]["logits"],
              f"{tf[part]['bad']} of {tf[part]['logits']} {part} logits beyond the"
              f" teacher-forced tolerance, more than {TF_RATE[part]} of them (largest deviation"
              f" {tf[part]['max_abs_err']:.4g})")
    for name, t in layers.items():
        check(t["bad"] == 0, f"layer by layer: {t['bad']} values of the {name} beyond"
              f" {t['tolerance']} (1 + |b|) (largest deviation {t['max_abs_err']:.4g})")
    t0 = time.perf_counter()
    controls = {}
    for name, stand_in in SSD_CONTROLS.items():
        with ssd_replaced(stand_in):
            ctokens, clogits = server.generate(prompts, max_new_tokens=HY_NEW, return_logits=True)
            controls[name] = teacher_forced(model, ctokens, clogits, plain=plain)
            controls[name]["layers"] = layer_by_layer(model, ctokens)
        del clogits
        c = controls[name]
        refused = (any(c[part]["bad"] > TF_RATE[part] * c[part]["logits"]
                       for part in ("served", "sequence"))
                   or any(t["bad"] > 0 for t in c["layers"].values()))
        print(f"  control {name}: {c['served']['bad']} served and {c['sequence']['bad']}"
              f" sequence logits beyond the tolerance; layer by layer "
              f"{json.dumps({k: t['bad'] for k, t in c['layers'].items()})} values beyond",
              flush=True)
        check(refused, f"the teacher-forced check passed a served run with {name}")
    phase("hybrid controls", t0, json.dumps(controls))
    torch.cuda.empty_cache()

    serve = serve_profile("hybrid", model, server, prompts, HY_NEW, stats, peak_gb, gpu)
    serve.update({
        "prefill_flops_bf16": pf_flops, "ssd_flops_per_launch": ssd_ops,
        "prefill_bound_s": pf_bound_s, "weight_bytes": weight_bytes, "kv_bytes": kv_bytes,
        "ssm_bytes": ssm_bytes, "decode_step_bytes": step_bytes,
        "decode_step_bound_s": step_bound_s, "teacher_forced": tf,
        "layer_by_layer": layers,
        "controls": controls,
    })
    del server, model
    torch.cuda.empty_cache()
    return {"counts": counts, "serve": serve}


def ssd_times(args, device) -> dict:
    """The SSD kernels at zamba2-7b's prefill shape beside their bound and
    their plain version.  No single PyTorch call computes the scan.
    ``bound_ms`` is the function's own: its float32 operations at the FMA
    rate against its bytes; ``x3_bound_ms`` is the bound of the kernels'
    arithmetic: each float32 product as six bf16 products at the dense bf16
    rate (``csrc/mma_x3.cuh``), against the bytes with the chunk-start
    states written and read back."""
    import torch

    from repro_torch.kernels.mamba2_ssd import KERNELS, head_tile, ssd_cuda, ssd_plain

    B, L, H, decay, _ = SSD_CASES["zamba2-7b prefill"]
    arrays, _ = ssd_inputs(B, L, H, decay, device, args.seed)
    nc = L // 128
    ht = head_tile(B * nc, H, torch.cuda.get_device_properties(device).multi_processor_count)
    ops, nbytes = ssd_work(B, L, H)
    b, by = bound_ms(nbytes, ops, FP32_OPS_PER_S)
    state_bytes = 2 * 4 * B * nc * H * 64 * 64
    b3, by3 = bound_ms(nbytes + state_bytes, 6 * ops, BF16_OPS_PER_S)
    out = {
        "ms": time_cuda(lambda i: ssd_cuda(*arrays), reps=REPS),
        "plain_ms": time_cuda(lambda i: ssd_plain(*arrays, chunk=128), reps=3),
        "library_ms": None,
        "device_ms": device_ms(lambda i: ssd_cuda(*arrays), REPS, *KERNELS),
        "kernels_per_call": len(KERNELS),
        "bound_ms": b, "bound_by": by, "flops": ops, "bytes": nbytes,
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / FP32_OPS_PER_S * 1e3,
        "x3_bound_ms": b3, "x3_bound_by": by3, "state_bytes": state_bytes,
        "head_tile": ht,
        "shape": f"xbar [{B}, {L}, {H}, 64], dA [{B}, {L}, {H}], B/C [{B}, {L}, 64] f32,"
                 f" chunk 128; ssd_state {B * H} CTAs, ssd_scan {B * nc * H // ht} CTAs of"
                 f" {ht} heads",
    }
    del arrays
    torch.cuda.empty_cache()
    return out


def flash_times(args, device, case: str = "llama3.2-1b prefill") -> dict:
    """The flash kernel at a path's shape (llama3.2-1b's or zamba2-7b's
    shared block's prefill, hubert-xlarge's encoder), bf16, in the layer's layout,
    beside its bound, its plain version and one
    ``scaled_dot_product_attention`` call on head-expanded K/V."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    B, H, Hkv, S, D, causal, strided = FLASH_CASES[case]
    q, k, v = flash_inputs(B, H, Hkv, S, D, torch.bfloat16, device, args.seed, strided)
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())     # q, k, v read; o written
    b, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
    qc = q.contiguous()
    ke = k.repeat_interleave(H // Hkv, dim=1).contiguous()
    ve = v.repeat_interleave(H // Hkv, dim=1).contiguous()
    out = {
        "ms": time_cuda(lambda i: flash_attention_cuda(q, k, v, causal=causal), reps=REPS),
        "plain_ms": time_cuda(lambda i: flash_attention_plain(q, k, v, causal=causal), reps=3),
        "library_ms": time_cuda(
            lambda i: F.scaled_dot_product_attention(qc, ke, ve, is_causal=causal), reps=REPS),
        "device_ms": device_ms(lambda i: flash_attention_cuda(q, k, v, causal=causal), REPS,
                               "fa_wgmma_bf16"),
        "bound_ms": b, "bound_by": by, "flops": flops, "bytes": nbytes,
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": flops / BF16_OPS_PER_S * 1e3,
        "shape": f"q [{B}, {H}, {S}, {D}], k/v [{B}, {Hkv}, {S}, {D}] bf16,"
                 f" {'causal' if causal else 'full'}, strided views of [B, S, heads, D]",
    }
    del q, k, v, qc, ke, ve
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# RWKV6: the rwkv6_wkv kernel, rwkv6-1.6b at full width
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-1.6b"
RW_BATCH, RW_PROMPT, RW_NEW = 8, 2048, 32
WKV_TOL = 2e-4    # tests/test_kernels.py:159-160, held as |a - b| <= tol (1 + |b|)
# the loss path's per-position cross entropy (logsumexp minus the gold
# logit, [8, 2048]) through the kernel against the plain one: none of the
# 16,384 positions more than NLL_TOL apart.  A sound run moves a position
# by the bf16 rounding of its gold logit.  On the H100 the sound run's
# largest gap was 0.0186 and the plain chunk-8 floor's 0.0159; the
# controls' were 0.309 (no carry, 1,197 positions beyond 0.05) and 0.208
# (u dropped, 5,344 beyond): 0.05 lies between (PERF.md section 6)
NLL_TOL = 0.05
WKV_CASES = {
    # name: (B, T, H, decay, h0); C = 64, the kernel's chunk 16
    "rwkv6-1.6b prefill": (8, 2048, 32, "model", False),
    "weak decay, w in [0.999, 1)": (2, 2048, 32, "weak", False),
    "strong decay, w = 1e-6 and a quarter 0": (2, 1024, 32, "strong", False),
    "ragged T = 2080, from h0": (2, 2080, 32, "model", True),
    "B = 1": (1, 2048, 32, "model", False),
}
WKV_SMOKE_C = 16   # rwkv6's smoke head dim, run through impl="auto"


def wkv_inputs(B, T, H, decay, device, seed, with_h0=False):
    """r, k, v [B, T, H, 64], the decay w in (0, 1), u [H, 64] and, with
    ``with_h0``, h0 [B, H, 64, 64], float32 on the card."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, 64), generator=g, device=device) for _ in range(3))
    if decay == "weak":
        # the state sums T nearly undecayed steps: k / sqrt(T) keeps it O(1),
        # as the SSD's weak case scales xbar; at unit scale y reaches ~1e2
        # by cancellation, where two float32 orders differ beyond 2e-4
        k = k * T ** -0.5
        w = 1 - 1e-3 * torch.rand((B, T, H, 64), generator=g, device=device)
    elif decay == "strong":
        w = torch.where(torch.rand((B, T, H, 64), generator=g, device=device) < 0.25,
                        torch.zeros((), device=device), torch.full((), 1e-6, device=device))
    else:   # as the model draws them: exp(-exp(w0 + noise)), w0 ~ N(0, 0.5)
        w0 = 0.5 * torch.randn((H, 64), generator=g, device=device)
        w = torch.exp(-torch.exp(w0 + 0.3 * torch.randn((B, T, H, 64), generator=g,
                                                        device=device)))
    u = 0.5 * torch.randn((H, 64), generator=g, device=device)
    h0 = torch.randn((B, H, 64, 64), generator=g, device=device) if with_h0 else None
    return (r, k, v, w, u), h0


def wkv_parity(args, device) -> float:
    """The WKV kernel (through ``ops.wkv6``, which pads a ragged T) against
    its plain chunked version at every case, y and h_final, and one small
    case against the step recurrence; returns the largest absolute
    deviation."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_scan

    worst = 0.0
    for i, (name, (B, T, H, decay, with_h0)) in enumerate(WKV_CASES.items()):
        arrays, h0 = wkv_inputs(B, T, H, decay, device, args.seed + 200 + i, with_h0)
        got = wkv6(*arrays, h0=h0, impl="cuda")
        want = wkv6(*arrays, h0=h0, impl="torch")
        torch.cuda.synchronize()
        for part, a, b in (("y", got[0], want[0]), ("h_final", got[1], want[1])):
            check(a.shape == b.shape, f"wkv {name} {part}: shape {tuple(a.shape)}")
            check(bool(torch.isfinite(a).all()), f"wkv {name} {part}: non-finite output")
            diff = (a - b).abs()
            bad = int((diff > WKV_TOL * (1 + b.abs())).sum())
            check(bad == 0, f"wkv {name} {part}: {bad} values beyond {WKV_TOL} (1 + |b|)"
                  f" (largest deviation {float(diff.max()):.3g})")
            worst = max(worst, float(diff.max()))
            print(f"  wkv {name} {part}: max |kernel - plain| {float(diff.max()):.3g},"
                  f" max |plain| {float(b.abs().max()):.3g}", flush=True)
        if decay == "weak":
            # the case has the power to see a kernel that drops the carry
            cut, _ = _wkv_no_carry(*arrays, None)
            far = int(((cut - want[0]).abs() > WKV_TOL * (1 + want[0].abs())).sum())
            print(f"  wkv {name}: the state not carried across chunks puts {far} of"
                  f" {cut.numel()} values of y beyond the tolerance", flush=True)
            check(far > 0, f"wkv {name}: a kernel without the inter-chunk carry passes")
            del cut
        del arrays, h0, got, want
    # the step recurrence, the reference's oracle, on a small case
    arrays, h0 = wkv_inputs(2, 100, 4, "model", device, args.seed + 210, True)
    got = wkv6(*arrays, h0=h0, impl="cuda")
    want = wkv6_scan(*arrays, h0=h0)
    for part, a, b in (("y", got[0], want[0]), ("h_final", got[1], want[1])):
        diff = (a - b).abs()
        bad = int((diff > WKV_TOL * (1 + b.abs())).sum())
        check(bad == 0, f"wkv against the recurrence {part}: {bad} values beyond {WKV_TOL}"
              f" (1 + |b|) (largest deviation {float(diff.max()):.3g})")
        print(f"  wkv against the step recurrence, [2, 100, 4, 64] from h0, {part}: max"
              f" |kernel - recurrence| {float(diff.max()):.3g}", flush=True)
    # rwkv6's smoke config (head dim 16) through auto, which pads C to 64
    from repro_torch.kernels import rwkv6_wkv

    (r, k, v, w, u), h0 = wkv_inputs(2, 100, 4, "model", device, args.seed + 220, True)
    r, k, v, w = (t[..., :WKV_SMOKE_C].contiguous() for t in (r, k, v, w))
    u, h0 = u[:, :WKV_SMOKE_C].contiguous(), h0[:, :, :WKV_SMOKE_C, :WKV_SMOKE_C].contiguous()
    before = rwkv6_wkv.LAUNCHES.value
    got = wkv6(r, k, v, w, u, h0=h0, impl="auto")
    check(rwkv6_wkv.LAUNCHES.value == before + 1, "wkv at C = 16: auto did not launch")
    want = wkv6(r, k, v, w, u, h0=h0, impl="torch")
    for part, a, b in (("y", got[0], want[0]), ("h_final", got[1], want[1])):
        diff = (a - b).abs()
        bad = int((diff > WKV_TOL * (1 + b.abs())).sum())
        check(a.shape == b.shape and bad == 0, f"wkv smoke {part}: {bad} values beyond"
              f" {WKV_TOL} (1 + |b|) (largest deviation {float(diff.max()):.3g})")
        worst = max(worst, float(diff.max()))
        print(f"  wkv smoke C = 16 through auto, [2, 100, 4, 16] from h0, {part}: max |kernel -"
              f" plain| {float(diff.max()):.3g}", flush=True)
    torch.cuda.empty_cache()
    return worst


def wkv_work(B, T, H, C=64, Q=16) -> tuple[int, int]:
    """(operations, bytes) of one WKV pass, counted from the kernel: per
    (b, h, chunk) the prefix sums, the two decayed operands (a subtraction,
    an exp and a product each), A once -- 5 operations a channel of each
    strictly lower pair --, the bonus, the inter-chunk product, the
    intra-chunk sum and the state update (2 operations a multiply-add); r,
    k, v, logw and u read once, y and h_final written once."""
    nc = -(-T // Q)
    pairs = Q * (Q - 1) // 2
    per_chunk = (Q * C + 5 * Q * C + C + 5 * pairs * C + 3 * Q * C
                 + 2 * Q * C * C + 2 * pairs * C + 3 * Q * C
                 + 2 * Q * C * C + 2 * C * C)
    ops = B * H * nc * per_chunk
    nbytes = 4 * (5 * B * T * H * C + H * C + B * H * C * C)
    return ops, nbytes


def rwkv_flops(cfg, batch: int, seq: int, every_position: bool) -> tuple[int, int]:
    """(bf16, float32) operations of a pass over ``batch x seq`` tokens:
    every bf16 projection (r, k, v, g, o, the channel mix's key, value and
    receptance; 2 a multiply-add) over every token and the unembedding of
    every position or of the last; the float32 low-rank products of the
    ddlerp and the decay.  The WKV's operations are counted apart
    (``wkv_work``)."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.lora_rank
    matrix = 6 * d * d + 2 * d * f
    lora = 10 * d * r + 2 * d * r
    tokens = batch * seq
    bf16 = 2 * cfg.num_layers * matrix * tokens + 2 * d * cfg.vocab_size * (
        tokens if every_position else batch)
    return bf16, 2 * cfg.num_layers * lora * tokens


@contextlib.contextmanager
def wkv_replaced(stand_in):
    """Run the model with ``stand_in(r, k, v, w, u, h0)`` in place of the
    WKV kernel; the plain version (``impl="torch"``) stays the yardstick."""
    from repro_torch.models import rwkv6

    real = rwkv6.wkv6

    def patched(r, k, v, w, u, *, h0=None, impl="auto"):
        if impl == "torch":
            return real(r, k, v, w, u, h0=h0, impl=impl)
        return stand_in(r, k, v, w, u, h0)

    rwkv6.wkv6 = patched
    try:
        yield
    finally:
        rwkv6.wkv6 = real


def _wkv_plain(r, k, v, w, u, h0):
    from repro_torch.kernels.rwkv6_wkv import wkv6

    return wkv6(r, k, v, w, u, h0=h0, impl="torch")


@contextlib.contextmanager
def logits_captured(model, into: list):
    """Append the logits of every forward of ``model`` to ``into`` (a
    forward hook): what the loss path computed its cross entropy from."""
    handle = model.register_forward_hook(lambda m, args, output: into.append(output[0]))
    try:
        yield
    finally:
        handle.remove()


def _wkv_no_carry(r, k, v, w, u, h0):
    """Every chunk of 16 from a zero state: the chunks go through the kernel
    as batch rows of their own; h_final is the last chunk's."""
    import torch.nn.functional as F

    from repro_torch.kernels.rwkv6_wkv import wkv6

    B, T, H, C = r.shape
    pad = (-T) % 16
    w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    padded = [F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v)] + [w]
    nc = (T + pad) // 16
    rows = [t.reshape(B * nc, 16, H, C).contiguous() for t in padded]
    y, h = wkv6(*rows, u, impl="cuda")
    return y.reshape(B, T + pad, H, C)[:, :T], h.reshape(B, nc, H, C, C)[:, -1]


def _wkv_no_bonus(r, k, v, w, u, h0):
    import torch

    from repro_torch.kernels.rwkv6_wkv import wkv6

    return wkv6(r, k, v, w, torch.zeros_like(u), h0=h0, impl="cuda")


# known-wrong WKV kernels the checks must refuse
WKV_CONTROLS = {"state not carried across chunks": _wkv_no_carry,
                "diagonal bonus u dropped": _wkv_no_bonus}


def compare_logits(got, want, chunk: int = 256) -> dict:
    """``logit_deviation`` of two [B, S, V] logit tensors, ``chunk``
    positions at a time."""
    return _combined([logit_deviation(got[:, i:i + chunk], want[:, i:i + chunk])
                      for i in range(0, got.shape[1], chunk)])


def rwkv_layer_by_layer(model, seq, caches=None) -> dict:
    """Each RWKV6 layer fed its input from a pass through the plain WKV
    (forward pre-hooks on the layers), and its time mix run from that input
    once through the kernel (``wkv_impl="auto"``) and once through the plain
    version: the time mix's output held to LAYER_TOL (1 + |b|), the WKV's
    y and final state to WKV_TOL (1 + |b|).  With ``caches`` (a fresh
    float32 state) the pass is a served prefill: each time mix starts from
    its layer's state.  Layers see the same input on both sides, so no
    rounding is carried from one layer to the next."""
    import torch

    out: dict = {}

    def hook(layer, args, kwargs):
        h = args[0]
        state = args[1] if len(args) > 1 else kwargs.get("state")
        t_state = state["time"] if state is not None else None
        res = {impl: layer.time_mix(h, t_state, wkv_impl=impl) for impl in ("auto", "torch")}
        _tally(out, "time-mix output", res["auto"][0], res["torch"][0], LAYER_TOL)
        _tally(out, "wkv y", res["auto"][2][0], res["torch"][2][0], WKV_TOL)
        _tally(out, "wkv state", res["auto"][2][1], res["torch"][2][1], WKV_TOL)

    hooks = [layer.register_forward_pre_hook(hook, with_kwargs=True) for layer in model.layers]
    try:
        with torch.no_grad():
            model.hidden(seq, caches=caches, wkv_impl="torch")
    finally:
        for h in hooks:
            h.remove()
    return out


def rwkv_scoring(model, batch_tokens, floor: bool = True) -> dict:
    """Scoring: ``make_forward_fn`` on the first S tokens and ``make_loss_fn``
    on all S + 1, each timed and its WKV launches counted, then held
    against the same calls through the plain WKV: every position's logits
    (TF_RATE's share beyond TF_TOL (1 + |b|)), the loss path's per-position
    cross entropy (NLL_TOL, none beyond), and layer by layer.  With
    ``floor``, also the plain calls at chunk 8 against chunk 16: what two
    sound versions differ by."""
    import torch

    from repro_torch import kernels
    from repro_torch.models import api
    from repro_torch.models.common import token_nll

    seq, gold = batch_tokens[:, :-1], batch_tokens[:, 1:]
    forward, loss_fn = api.make_forward_fn(model), api.make_loss_fn(model)

    def per_position(seen: list, loss) -> torch.Tensor:
        """The cross entropy [B, S] of the logits the loss path computed."""
        nll = token_nll(seen.pop(), gold)
        check(abs(float(nll.mean()) - float(loss)) <= 1e-6 * abs(float(loss)),
              f"the captured cross entropy's mean {float(nll.mean())} is not the loss {float(loss)}")
        return nll

    def loss_nll():
        seen: list = []
        with logits_captured(model, seen):
            loss, _ = loss_fn({"tokens": batch_tokens})
        return float(loss), per_position(seen, loss)

    out: dict = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits = forward({"tokens": seq})
        torch.cuda.synchronize()
        out["forward_s"] = time.perf_counter() - t0
        out["forward_counts"] = kernels.launch_counts()   # the forward path ends here
        kernels.reset_launch_counts()
        seen: list = []
        with logits_captured(model, seen):
            t0 = time.perf_counter()
            loss, _ = loss_fn({"tokens": batch_tokens})
            torch.cuda.synchronize()
            out["loss_s"] = time.perf_counter() - t0
        out["loss_counts"] = kernels.launch_counts()      # the loss path ends here
        out["loss"] = float(loss)
        nll = per_position(seen, loss)
        check(bool(torch.isfinite(logits).all()), "scoring logits are not finite")
        check(tuple(logits.shape) == (*seq.shape, model.cfg.vocab_size),
              f"scoring logits {tuple(logits.shape)}")
        with wkv_replaced(_wkv_plain):
            plain = forward({"tokens": seq})
            out["plain_loss"], plain_nll = loss_nll()
        out["logits"] = compare_logits(logits, plain)
        del logits
        out["nll"] = nll_deviation(nll, plain_nll)
        out["loss_rel_err"] = abs(out["loss"] - out["plain_loss"]) / abs(out["plain_loss"])
        if floor:
            from repro_torch.kernels.rwkv6_wkv import log_decay, wkv6_plain

            def chunk8(r, k, v, w, u, h0):
                return wkv6_plain(r, k, v, log_decay(w), u, h0=h0, chunk=8)

            with wkv_replaced(chunk8):
                other = forward({"tokens": seq})
                other_loss, other_nll = loss_nll()
            out["plain_floor"] = {"logits": compare_logits(other, plain),
                                  "nll": nll_deviation(other_nll, plain_nll),
                                  "loss_rel_err": abs(other_loss - out["plain_loss"])
                                  / abs(out["plain_loss"])}
            del other
        del plain
    out["layers"] = rwkv_layer_by_layer(model, seq)
    return out


def nll_deviation(got, want) -> dict:
    """How far two per-position cross entropies are apart: the largest
    gap, the positions beyond NLL_TOL, and the positions beyond a ladder of
    gaps (what a limit between a sound run and a wrong one is read from)."""
    diff = (got - want).abs()
    return {"positions": diff.numel(), "max_abs_err": float(diff.max()),
            "bad": int((diff > NLL_TOL).sum()), "tolerance": NLL_TOL,
            "beyond": {str(t): int((diff > t).sum()) for t in (0.01, 0.02, 0.05, 0.1, 0.2, 0.5)}}


def scoring_refusals(sc: dict) -> list[str]:
    """The parts of the scoring check that refuse ``sc``."""
    parts = []
    if sc["logits"]["bad"] > TF_RATE["sequence"] * sc["logits"]["logits"]:
        parts.append("every-position logits")
    if sc["nll"]["bad"] > 0:
        parts.append("loss: per-position cross entropy")
    parts += [f"layer by layer: {name}" for name, t in sc["layers"].items() if t["bad"] > 0]
    return parts


def rwkv_served_check(model, prompts, tokens, step_logits) -> dict:
    """The served sequence teacher-forced through the plain WKV from a fresh
    float32 state (the served path's own numerics: a stateless forward
    shifts in bf16): its prompt's prefill and one decode step a new token,
    the logits that chose each new token held against the served ones;
    the states after the prompt, a prefill through the kernel against one
    through the plain version, held to LAYER_TOL (1 + |b|); and the served
    prefill layer by layer."""
    import torch

    from repro_torch.models.transformer import init_caches

    cfg = model.cfg
    B, P = prompts.shape
    seq = torch.as_tensor(tokens, device=step_logits.device, dtype=torch.int64)
    new = tokens.shape[1] - P
    out: dict = {}
    with torch.no_grad():
        states = {}
        for impl in ("auto", "torch"):
            caches = init_caches(cfg, B, P + new, torch.float32, seq.device)
            h, caches = model.hidden(seq[:, :P], caches=caches, wkv_impl=impl)
            states[impl] = (model.logits(h[:, -1:]), caches)
        got, want = states["auto"][1]["layers"], states["torch"][1]["layers"]
        after: dict = {}
        for part, name in (("time", "shift"), ("time", "wkv"), ("channel", "shift")):
            _tally(after, f"{part} {name}", got[part][name], want[part][name], LAYER_TOL)
        out["states_after_prompt"] = after
        logits, caches = states.pop("torch")     # decoding goes on from the plain prefill
        del states, got, want
        steps = [logits[:, -1]]
        for t in range(new - 1):
            logits, caches = model(seq[:, P + t:P + t + 1], caches=caches)
            steps.append(logits[:, -1])
        out["served"] = logit_deviation(torch.stack(steps, 1), step_logits)
        del caches
    fresh = init_caches(cfg, B, P, torch.float32, seq.device)
    out["prefill_layers"] = rwkv_layer_by_layer(model, seq[:, :P], caches=fresh)
    return out


def served_refusals(sv: dict) -> list[str]:
    parts = []
    if sv["served"]["bad"] > TF_RATE["served"] * sv["served"]["logits"]:
        parts.append("served logits")
    parts += [f"state after the prompt: {n}" for n, t in sv["states_after_prompt"].items()
              if t["bad"] > 0]
    parts += [f"prefill layer by layer: {n}" for n, t in sv["prefill_layers"].items()
              if t["bad"] > 0]
    return parts


def rwkv_serving(args, device, gpu: str) -> dict:
    """Score and serve rwkv6-1.6b at full width and depth."""
    import math

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import iter_leaves
    from repro_torch.models.transformer import RWKVLM
    from repro_torch.serve import Server

    cfg = ARCHS[RWKV_ARCH]
    rcfg = cfg.rwkv_config()
    H, C = rcfg.num_heads, rcfg.head_dim
    rng = np.random.default_rng(args.seed + 11)
    t0 = time.perf_counter()
    model = RWKVLM(cfg, device=device, seed=args.seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = 4 * n_params
    wkv_bytes = cfg.num_layers * RW_BATCH * H * C * C * 4
    shift_bytes = 2 * cfg.num_layers * RW_BATCH * cfg.d_model * 4
    phase("rwkv model", t0, f"{cfg.name}: {n_params:,} float32 parameters"
          f" ({weight_bytes / 1e9:.3f} GB), seed {args.seed}; float32 WKV states of"
          f" {cfg.num_layers} layers {wkv_bytes / 1e9:.4f} GB, shift states"
          f" {shift_bytes / 1e9:.4f} GB")
    n_specs = sum(math.prod(s.shape) for _, s in iter_leaves(api.model_specs(cfg)))
    check(n_params == n_specs, f"{cfg.name} holds {n_params:,} parameters, its specs {n_specs:,}")
    # least times: the bf16 projections at the tensor-core peak, the float32
    # low-rank products at the FMA peak and the 24 WKV passes at their bound;
    # a decode step reads every weight but the embedding table (B rows of
    # it) and reads and writes the WKV and shift states
    wkv_ops, wkv_nbytes = wkv_work(RW_BATCH, RW_PROMPT, H)
    wkv_bound_s = bound_ms(wkv_nbytes, wkv_ops)[0] / 1e3
    bounds = {}
    for name, every in (("prefill", False), ("forward", True)):
        bf, f32 = rwkv_flops(cfg, RW_BATCH, RW_PROMPT, every)
        bounds[name] = {"bf16_flops": bf, "f32_flops": f32, "bf16_s": bf / BF16_OPS_PER_S,
                        "f32_s": f32 / FP32_OPS_PER_S, "wkv_s": cfg.num_layers * wkv_bound_s,
                        "bound_s": bf / BF16_OPS_PER_S + f32 / FP32_OPS_PER_S
                        + cfg.num_layers * wkv_bound_s}
    table = model.embed.table
    step_bytes = (weight_bytes - 4 * table.numel() + 4 * RW_BATCH * cfg.d_model
                  + 2 * (wkv_bytes + shift_bytes))
    step_bound_s = step_bytes / HBM_BYTES_PER_S
    for name, b in bounds.items():
        print(f"rwkv {cfg.name} bounds: {name} {b['bf16_flops'] / 1e12:.2f} TFLOP bf16"
              f" ({b['bf16_s']:.4f} s at the bf16 peak), {b['f32_flops'] / 1e12:.3f} TFLOP"
              f" float32 low-rank ({b['f32_s']:.4f} s), {cfg.num_layers} WKV passes"
              f" ({b['wkv_s']:.4f} s), {b['bound_s']:.4f} s in all", flush=True)
    print(f"rwkv {cfg.name} bounds: decode step {step_bytes / 1e9:.3f} GB,"
          f" {step_bound_s * 1e3:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, so at most"
          f" {RW_BATCH / step_bound_s:.0f} tokens/s", flush=True)

    # (a) scoring: every position's logits and the loss, through the kernel
    batch_tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (RW_BATCH, RW_PROMPT + 1), np.int64)).to(device)
    with torch.no_grad():      # warm-up at the full shape: cuBLAS plans, allocator blocks
        api.make_loss_fn(model)({"tokens": batch_tokens.flip(0)})
    t0 = time.perf_counter()
    sc = rwkv_scoring(model, batch_tokens)
    phase("rwkv scoring", t0, json.dumps(sc))
    for what in ("forward_counts", "loss_counts"):
        check(sc[what]["rwkv6_wkv"] == cfg.num_layers,
              f"the {what.split('_')[0]} launched rwkv6_wkv {sc[what]['rwkv6_wkv']} times,"
              f" not {cfg.num_layers}")
    refused = scoring_refusals(sc)
    check(not refused, f"scoring through the kernel refused by: {refused}"
          f" ({json.dumps({k: sc[k] for k in ('logits', 'nll', 'layers')})})")
    fwd_tps = RW_BATCH * RW_PROMPT / sc["forward_s"]
    print(f"rwkv {cfg.name} scoring {RW_BATCH} x {RW_PROMPT}: forward {sc['forward_s']:.4f} s"
          f" ({fwd_tps:.0f} tokens/s), loss {sc['loss_s']:.4f} s (loss {sc['loss']:.6f},"
          f" plain {sc['plain_loss']:.6f}) [{gpu}]", flush=True)

    # (b) serving
    server = Server(cfg, model, device=device)
    prompts = rng.integers(0, cfg.vocab_size, (RW_BATCH, RW_PROMPT), np.int32)
    server.generate(prompts[::-1].copy(), max_new_tokens=2)      # warm-up at the full prompt
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    tokens, step_logits = server.generate(prompts, max_new_tokens=RW_NEW, return_logits=True)
    counts = kernels.launch_counts()            # the serving path ends here
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = dict(server.last_stats)
    phase("rwkv serve", t0, f"Server.generate {RW_BATCH} x {RW_PROMPT} + {RW_NEW};"
          f" launches {json.dumps(counts)}")
    check(counts["rwkv6_wkv"] == cfg.num_layers,
          f"Server.generate launched rwkv6_wkv {counts['rwkv6_wkv']} times, not {cfg.num_layers}")
    check(tokens.shape == (RW_BATCH, RW_PROMPT + RW_NEW), f"tokens {tokens.shape}")
    check(bool((tokens[:, :RW_PROMPT] == prompts).all()), "the prompts came back changed")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size, "token ids out of range")
    check(bool(torch.isfinite(step_logits).all()), "served logits are not finite")
    t0 = time.perf_counter()
    sv = rwkv_served_check(model, prompts, tokens, step_logits)
    phase("rwkv teacher forcing", t0, f"{json.dumps(sv)} (tolerance {TF_TOL} (1 + |b|))")
    refused = served_refusals(sv)
    check(not refused, f"serving through the kernel refused by: {refused}")
    del step_logits

    # (c) controls: serve and score with known-wrong kernels; both must be refused
    t0 = time.perf_counter()
    controls = {}
    for name, stand_in in WKV_CONTROLS.items():
        with wkv_replaced(stand_in):
            c_sc = rwkv_scoring(model, batch_tokens, floor=False)
            ctokens, clogits = server.generate(prompts, max_new_tokens=RW_NEW,
                                               return_logits=True)
            c_sv = rwkv_served_check(model, prompts, ctokens, clogits)
        del clogits
        by = {"scoring": scoring_refusals(c_sc), "serving": served_refusals(c_sv)}
        controls[name] = {"scoring": {k: c_sc[k] for k in ("logits", "nll", "loss_rel_err",
                                                           "layers")},
                          "serving": c_sv, "refused_by": by}
        print(f"  control {name}: refused by {json.dumps(by)}", flush=True)
        check(by["scoring"] and by["serving"],
              f"the checks passed a run with {name}: refused by {json.dumps(by)}")
    phase("rwkv controls", t0, json.dumps(controls))
    torch.cuda.empty_cache()

    serve = serve_profile("rwkv", model, server, prompts, RW_NEW, stats, peak_gb, gpu,
                          forward=True)
    serve.update({
        "bounds": bounds, "weight_bytes": weight_bytes, "wkv_state_bytes": wkv_bytes,
        "decode_step_bytes": step_bytes, "decode_step_bound_s": step_bound_s,
        "served_check": sv, "controls": controls,
    })
    scoring = {k: v for k, v in sc.items()}
    scoring["forward_tokens_per_s"] = fwd_tps
    del server, model, batch_tokens
    torch.cuda.empty_cache()
    return {"counts": {"forward": sc["forward_counts"], "loss": sc["loss_counts"],
                       "generate": counts},
            "scoring": scoring, "serve": serve}


def wkv_times(args, device) -> dict:
    """The WKV kernel at rwkv6-1.6b's prefill shape beside its bound and its
    plain version.  No single PyTorch call computes the recurrence.
    ``bound_ms`` is the function's own (every operation at the FMA rate);
    ``x3_bound_ms`` is the bound of the kernel's arithmetic: its three
    products on the tensor cores (the inter-chunk term, A' v and the state
    update) as six bf16 products each at the dense bf16 rate
    (``csrc/mma_x3.cuh``) and the rest at the FMA rate, against the same
    bytes (nothing is materialised)."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import KERNELS, log_decay, wkv6_cuda, wkv6_plain

    B, T, H, decay, _ = WKV_CASES["rwkv6-1.6b prefill"]
    (r, k, v, w, u), _ = wkv_inputs(B, T, H, decay, device, args.seed)
    logw = log_decay(w)
    ops, nbytes = wkv_work(B, T, H)
    b, by = bound_ms(nbytes, ops, FP32_OPS_PER_S)
    Q, C, pairs = 16, 64, 16 * 15 // 2
    chunks = B * H * (T // Q)
    mma_ops = chunks * (2 * 2 * Q * C * C + 2 * Q * Q * C)     # as the kernel runs them
    counted = chunks * (2 * 2 * Q * C * C + 2 * pairs * C)     # the same in wkv_work
    ops3_ms = (6 * mma_ops / BF16_OPS_PER_S + (ops - counted) / FP32_OPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {
        "ms": time_cuda(lambda i: wkv6_cuda(r, k, v, logw, u), reps=REPS),
        "plain_ms": time_cuda(lambda i: wkv6_plain(r, k, v, logw, u), reps=3),
        "library_ms": None,
        "device_ms": device_ms(lambda i: wkv6_cuda(r, k, v, logw, u), REPS, *KERNELS),
        "kernels_per_call": len(KERNELS),
        "bound_ms": b, "bound_by": by, "flops": ops, "bytes": nbytes,
        "bytes_ms": bytes_ms, "ops_ms": ops / FP32_OPS_PER_S * 1e3,
        "x3_bound_ms": max(bytes_ms, ops3_ms),
        "x3_bound_by": "bytes" if bytes_ms >= ops3_ms else "operations",
        "shape": f"r/k/v/logw [{B}, {T}, {H}, 64] f32, u [{H}, 64], chunk 16,"
                 f" {B * H} CTAs",
    }
    del r, k, v, w, u, logw
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The SSD and WKV backward kernels (training) against their plain versions
# ---------------------------------------------------------------------------

# a gradient of one position (dxbar; dr, dk, dv) is held as the forwards
# are, |a - b| <= tol (1 + |b|); one that sums over the sequence or the
# heads (ddA, dB, dC; dlogw, du) in relative L2, since a sum of thousands
# of terms in another order moves its small entries by more than 2e-4 of
# themselves
SCAN_BWD_SUM_REL_L2 = 1e-4
SSD_BWD_CASES = {
    # name: (B, L, H, decay); P = N = 64, chunk 128, no final-state gradient
    "zamba2-7b train": (8, 2048, 112, "softplus"),
    "weak decay, dA in [-1e-3, 0]": (2, 2048, 112, "weak"),
    "strong decay, dA = -30": (2, 1024, 112, "strong"),
}
WKV_BWD_CASES = {
    # name: (B, T, H, decay); C = 64, chunk 16, no final-state gradient
    "rwkv6-1.6b train": (8, 2048, 32, "model"),
    "weak decay, w in [0.999, 1)": (2, 2048, 32, "weak"),
    "strong decay, w = 1e-6 and a quarter 0": (2, 1024, 32, "strong"),
}


def scan_bwd_close(tag: str, names, got, want, summed) -> dict:
    """Each gradient of ``got`` against ``want``: elementwise within
    SSD_TOL (1 + |b|) or, for the ``summed`` ones, within
    SCAN_BWD_SUM_REL_L2 relative L2; returns each one's largest absolute
    deviation and relative L2 distance."""
    import torch

    out = {}
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()), f"{tag} {name}: shape"
              f" {tuple(a.shape)} or a non-finite value")
        diff = (a - b).abs()
        rel = float(diff.norm() / b.norm())
        out[name] = {"max_abs_err": float(diff.max()), "rel_l2": rel,
                     "max_abs_plain": float(b.abs().max())}
        if i in summed:
            check(rel <= SCAN_BWD_SUM_REL_L2, f"{tag} {name}: relative L2 {rel:.3g} beyond"
                  f" {SCAN_BWD_SUM_REL_L2}")
        else:
            bad = int((diff > SSD_TOL * (1 + b.abs())).sum())
            check(bad == 0, f"{tag} {name}: {bad} values beyond {SSD_TOL} (1 + |b|) (largest"
                  f" deviation {float(diff.max()):.3g})")
        print(f"  {tag} {name}: max |kernel - plain| {float(diff.max()):.3g} (max |plain|"
              f" {float(b.abs().max()):.3g}), relative L2 {rel:.3g}", flush=True)
    return out


def ssd_bwd_inputs(B, L, H, decay, device, seed):
    """The SSD's inputs, the forward kernel's chunk-start states and a dy
    from the seed (scaled by 1 / sqrt(L) at weak decay, as the forward's
    case scales xbar: the state's gradient then stays O(1))."""
    import torch

    from repro_torch.kernels.mamba2_ssd import ssd_cuda

    arrays, _ = ssd_inputs(B, L, H, decay, device, seed)
    _, _, hs = ssd_cuda(*arrays, states=True)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn((B, L, H, 64), generator=g, device=device)
    if decay == "weak":
        dy = dy * L ** -0.5
    return (*arrays, hs, dy)


def ssd_bwd_parity(args, device) -> dict:
    """The SSD backward kernels against their plain version at every case,
    and the same bits from a second call (no atomics)."""
    import torch

    from repro_torch.kernels.mamba2_ssd import ssd_bwd_cuda, ssd_bwd_plain

    out = {}
    for i, (name, (B, L, H, decay)) in enumerate(SSD_BWD_CASES.items()):
        args_ = ssd_bwd_inputs(B, L, H, decay, device, args.seed + 300 + i)
        got = ssd_bwd_cuda(*args_)
        want = ssd_bwd_plain(*args_, chunk=128)
        torch.cuda.synchronize()
        out[name] = scan_bwd_close(f"ssd bwd {name}", ("dxbar", "ddA", "dB", "dC"), got, want,
                                   summed={1, 2, 3})
        again = ssd_bwd_cuda(*args_)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"ssd bwd {name}: a second call gave other bits")
        del args_, got, want, again
    torch.cuda.empty_cache()
    return out


def wkv_bwd_inputs(B, T, H, decay, device, seed):
    """The WKV's inputs (the log-decay as ``ops.wkv6`` takes it), the
    forward kernel's chunk-start states and a dy from the seed (scaled by
    1 / sqrt(T) at weak decay, as the forward's case scales k: the state's
    gradient then stays O(1))."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import log_decay, wkv6_cuda

    (r, k, v, w, u), _ = wkv_inputs(B, T, H, decay, device, seed)
    logw = log_decay(w)
    _, _, hs = wkv6_cuda(r, k, v, logw, u, states=True)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn((B, T, H, 64), generator=g, device=device)
    if decay == "weak":
        dy = dy * T ** -0.5
    return r, k, v, logw, u, hs, dy


def wkv_bwd_parity(args, device) -> dict:
    """The WKV backward kernel against its plain version at every case,
    and the same bits from a second call (du summed in a fixed order)."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import wkv6_bwd_cuda, wkv6_bwd_plain

    out = {}
    for i, (name, (B, T, H, decay)) in enumerate(WKV_BWD_CASES.items()):
        args_ = wkv_bwd_inputs(B, T, H, decay, device, args.seed + 400 + i)
        got = wkv6_bwd_cuda(*args_)
        want = wkv6_bwd_plain(*args_)
        torch.cuda.synchronize()
        out[name] = scan_bwd_close(f"wkv bwd {name}", ("dr", "dk", "dv", "dlogw", "du"), got,
                                   want, summed={3, 4})
        again = wkv6_bwd_cuda(*args_)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"wkv bwd {name}: a second call gave other bits")
        del args_, got, want, again
    torch.cuda.empty_cache()
    return out


def worst_abs(parity: dict) -> float:
    return max(g["max_abs_err"] for case in parity.values() for g in case.values())


def worst_rel_l2(parity: dict, names) -> float:
    """The largest relative L2 distance of the named (summed) gradients
    over the cases."""
    return max(case[n]["rel_l2"] for case in parity.values() for n in names)


def ssd_bwd_work(B, L, H, P=64, N=64, Q=128) -> tuple[int, int]:
    """(operations, bytes) of one SSD backward, counted from its algebra:
    per batch row and chunk C B^T's causal half (B and C are shared by the
    heads); per chunk and head the state gradient's update and the three
    chunk-boundary products (dxbar's, dB's, dC's), and over the chunk's
    causal pairs dy . xbar, the two weightings and exponents, the three
    intra-chunk products and the decay's path sums (2 operations a
    multiply-add); xbar, dy, dA, B, C and the chunk-start states read once,
    dxbar, ddA, dB and dC written once."""
    nc = -(-L // Q)
    tri = Q * (Q + 1) // 2
    per_head = 4 * 2 * Q * P * N + tri * (2 * P + 2 * P + 2 * N + 2 * N + 6)
    ops = B * nc * (2 * tri * N + H * per_head)
    nbytes = 4 * (3 * B * L * H * P + 2 * B * L * H + 4 * B * L * N + B * nc * H * P * N)
    return ops, nbytes


def wkv_bwd_work(B, T, H, C=64, Q=16) -> tuple[int, int]:
    """(operations, bytes) of one WKV backward, counted from its algebra:
    per (b, h, chunk) the four [Q, C] x [C, C] products (the state's
    gradient update, S dy, G v, G^T kdec), vd over the chunk's pairs, and
    over its strictly lower pairs E (a subtraction and an exp), dr's, dk's
    and dv's intra-chunk terms, A, P and dlogw's path sums, plus the
    elementwise terms of each step; r, k, v, logw, dy and the chunk-start
    states read once, dr, dk, dv, dlogw and du written once."""
    nc = -(-T // Q)
    pairs = Q * (Q - 1) // 2
    per_chunk = 8 * Q * C * C + 2 * Q * Q * C + pairs * C * 17 + 12 * Q * C
    ops = B * H * nc * per_chunk
    nbytes = 4 * (9 * B * T * H * C + B * nc * H * C * C + 2 * H * C)
    return ops, nbytes


def ssd_bwd_times(args, device) -> dict:
    """The SSD backward kernels at zamba2-7b's training shape beside their
    bound and their plain version.  No single PyTorch call computes the
    scan's gradient.  ``bound_ms`` is the function's own (its operations at
    the float32 FMA rate against its bytes); ``x3_bound_ms`` is the bound
    of the same operations as six bf16 products each at the dense bf16 rate
    (``csrc/mma_x3.cuh``), against the bytes with G_end written and read
    back."""
    import torch

    from repro_torch.kernels.mamba2_ssd import (
        BWD_KERNELS,
        bwd_head_tile,
        ssd_bwd_cuda,
        ssd_bwd_plain,
    )

    B, L, H, decay = SSD_BWD_CASES["zamba2-7b train"]
    args_ = ssd_bwd_inputs(B, L, H, decay, device, args.seed)
    ops, nbytes = ssd_bwd_work(B, L, H)
    b, by = bound_ms(nbytes, ops, FP32_OPS_PER_S)
    nc = L // 128
    state_bytes = 2 * 4 * B * nc * H * 64 * 64
    b3, by3 = bound_ms(nbytes + state_bytes, 6 * ops, BF16_OPS_PER_S)
    ht = bwd_head_tile(B * nc, H, torch.cuda.get_device_properties(device).multi_processor_count)
    run = lambda i: ssd_bwd_cuda(*args_)  # noqa: E731
    out = {
        "ms": time_cuda(run, reps=REPS),
        "plain_ms": time_cuda(lambda i: ssd_bwd_plain(*args_, chunk=128), reps=2),
        "library_ms": None,
        "device_ms": device_ms(run, REPS, *BWD_KERNELS),
        "kernels_per_call": len(BWD_KERNELS),
        "bound_ms": b, "bound_by": by, "flops": ops, "bytes": nbytes,
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / FP32_OPS_PER_S * 1e3,
        "x3_bound_ms": b3, "x3_bound_by": by3, "state_bytes": state_bytes, "head_tile": ht,
        "shape": f"xbar, dy [{B}, {L}, {H}, 64], dA [{B}, {L}, {H}], B/C [{B}, {L}, 64] f32,"
                 f" chunk 128; ssd_bwd_state {B * H} CTAs, ssd_bwd_tile"
                 f" {B * nc * H // ht} CTAs of {ht} heads",
    }
    del args_
    torch.cuda.empty_cache()
    return out


def wkv_bwd_times(args, device) -> dict:
    """The WKV backward kernels at rwkv6-1.6b's training shape beside their
    bound and their plain version.  No single PyTorch call computes the
    recurrence's gradient.  ``bound_ms`` is the function's own (every
    operation at the FMA rate); ``x3_bound_ms`` is the bound of the
    kernels' arithmetic, their products on the tensor cores (the state's
    gradient update, S dy, G v, G^T kdec and vd) as six bf16 products each
    at the dense bf16 rate and the rest at the FMA rate, against the bytes
    with G_end written and read back."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import (
        BWD_GROUP,
        BWD_KERNELS,
        bwd_groups,
        wkv6_bwd_cuda,
        wkv6_bwd_plain,
    )

    B, T, H, decay = WKV_BWD_CASES["rwkv6-1.6b train"]
    args_ = wkv_bwd_inputs(B, T, H, decay, device, args.seed)
    ops, nbytes = wkv_bwd_work(B, T, H)
    b, by = bound_ms(nbytes, ops, FP32_OPS_PER_S)
    Q, C = 16, 64
    chunks = B * H * (T // Q)
    mma_ops = chunks * (8 * Q * C * C + 2 * Q * Q * C)    # the same in wkv_bwd_work
    ops3_ms = (6 * mma_ops / BF16_OPS_PER_S + (ops - mma_ops) / FP32_OPS_PER_S) * 1e3
    state_bytes = 2 * 4 * chunks * C * C
    bytes3_ms = (nbytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    run = lambda i: wkv6_bwd_cuda(*args_)  # noqa: E731
    out = {
        "ms": time_cuda(run, reps=REPS),
        "plain_ms": time_cuda(lambda i: wkv6_bwd_plain(*args_), reps=2),
        "library_ms": None,
        "device_ms": device_ms(run, REPS, *BWD_KERNELS),
        "kernels_per_call": len(BWD_KERNELS),
        "bound_ms": b, "bound_by": by, "flops": ops, "bytes": nbytes,
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / FP32_OPS_PER_S * 1e3,
        "x3_bound_ms": max(bytes3_ms, ops3_ms),
        "x3_bound_by": "bytes" if bytes3_ms >= ops3_ms else "operations",
        "state_bytes": state_bytes,
        "shape": f"r/k/v/logw/dy [{B}, {T}, {H}, 64] f32, u [{H}, 64], chunk 16;"
                 f" wkv6_bwd_state {B * H} CTAs, wkv6_bwd_chunk {B * H * bwd_groups(T)} CTAs"
                 f" of {BWD_GROUP} chunks",
    }
    del args_
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# MoE serving: granite-moe-3b-a800m at full width and depth, qwen3-moe-30b-a3b
# at full width and MOE_BIG_LAYERS of its 48 layers
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
MOE_BIG_ARCH = "qwen3-moe-30b-a3b"
# qwen3-moe's 48 layers are 122 GB of float32 weights; 8 are 20.0 GB, plus
# 2.5 GB of embeddings.  Its dropless prefill buffer [E, B*S, d] in bf16 is
# 128 x 8,192 x 2,048 x 2 B = 4.3 GB at 8 x 1024 (8.6 GB at 8 x 2048), and
# the expert outputs as much again, plus [E, B*S, 768] twice: 8 x 1024 keeps
# a layer's transient buffers near 13 GB
MOE_BIG_LAYERS = 8
# The shares of teacher-forced logits beyond TF_TOL (1 + |b|) an MoE run
# may have.  The random models' logits are ~1, so TF_TOL (1 + |b|) is ~0.1,
# and 32 layers of bf16 experts carry float32-level differences past it even
# with the expert choices replayed.  Set above what one run on an NVIDIA
# H100 80GB HBM3 at 700 W gave: served through the plain attention with no
# kernel at all, 45,831
# of granite's 25.2M served logits (1.82e-3) and 79 of qwen3-moe's 19.4M;
# the sound kernel run 49,422 (1.96e-3) and 84 served, 3.83e-3 and 1.6e-5
# of every position's.  The known-wrong attentions put 3.9e-3 and 1.1e-2
# of the served logits and 0.47 and 0.63 of every position's beyond it;
# the layer-by-layer check (LAYER_TOL, none beyond) refuses them too.
MOE_TF_RATE = {"served": 2.5e-3, "sequence": 1e-2}
MOE_BIG_BATCH, MOE_BIG_PROMPT, MOE_BIG_NEW = 8, 1024, 16


@contextlib.contextmanager
def routing_recorded(into: list):
    """Record every MoE layer's top-k expert choice ``[G, T, k]``, in call
    order, while a served run routes its tokens."""
    from repro_torch.models import moe

    real = moe.route

    def recording(params, xt, cfg):
        out = real(params, xt, cfg)
        into.append(out[3])
        return out

    moe.route = recording
    try:
        yield
    finally:
        moe.route = real


def served_routing(records: list, layers: int, batch: int) -> list:
    """Each layer's expert choices over a served run's tokens ``[B, P +
    new - 1, k]``, from the records of its prefill (``[1, B*P, k]``) and
    decode steps (``[1, B, k]``), ``layers`` records a pass."""
    import torch

    passes = [records[i:i + layers] for i in range(0, len(records), layers)]
    return [torch.cat([p[i].reshape(batch, -1, p[i].shape[-1]) for p in passes], dim=1)
            for i in range(layers)]


@contextlib.contextmanager
def routing_replayed(per_layer: list):
    """Route a pass's tokens to the experts a served run chose (layer by
    layer, in call order), each choice's weights renormalised from this
    pass's own router probabilities.  Top-k is discontinuous: a router
    input one bf16 ulp away can swap a token's experts, and a random model's
    logits then move by whole units; with the choices held fixed, the
    comparison sees the attention's numerics alone."""
    import torch

    from repro_torch.models import moe

    real = moe.route
    calls = iter(per_layer)

    def replaying(params, xt, cfg):
        logits, probs, _, _ = real(params, xt, cfg)
        idx = next(calls).reshape(xt.shape[0], xt.shape[1], -1)
        top = torch.gather(probs, -1, idx)
        return logits, probs, top / torch.clamp_min(top.sum(-1, keepdim=True), 1e-9), idx

    moe.route = replaying
    try:
        yield
    finally:
        moe.route = real


def moe_teacher_forced(model, tokens, step_logits, routing: list) -> dict:
    """``teacher_forced`` for an MoE model: the served sequence through
    cached passes from fresh float32 caches, so that the experts dispatch
    dropless as the served prefill and decode do (a stateless pass drops
    at the configured capacity, as the reference's does), with the served
    run's expert choices replayed (``routing_replayed``)."""
    import torch

    from repro_torch.models.transformer import init_caches

    seq = torch.as_tensor(tokens, device=step_logits.device, dtype=torch.int64)[:, :-1]
    B, L = seq.shape
    start = L - step_logits.shape[1] + 1
    with torch.no_grad():
        hs = {}
        for name, impl in (("plain", "torch"), ("model", "auto")):
            caches = init_caches(model.cfg, B, L, torch.float32, step_logits.device)
            with routing_replayed(routing):
                hs[name], _ = model.hidden(seq, caches=caches, attn_impl=impl)
            del caches
        served = logit_deviation(model.logits(hs["plain"][:, start - 1:]), step_logits)
        sequence = compare_hidden(model, hs["model"], hs["plain"])
    return {"served": served, "sequence": sequence}


def moe_layer_by_layer(model, tokens) -> dict:
    """Each layer's attention fed the layer's input from a cached pass
    through the plain attention (forward pre-hooks on the layers), and run
    from that input once through the kernel (``impl="auto"``) and once
    through the plain version: the outputs held to LAYER_TOL (1 + |b|) at
    every position of every layer.  Layers see the same input on both
    sides, so no rounding is carried from one layer to the next, and no
    expert choice can differ."""
    import torch

    from repro_torch.models import attention
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.transformer import init_caches

    seq = torch.as_tensor(tokens, device=model.embed.table.device, dtype=torch.int64)[:, :-1]
    out: dict = {}

    def layer_input(layer, args, kwargs):
        h, positions = args[:2]
        a_in = rmsnorm(layer.norm1, h, eps=layer.cfg.norm_eps)
        got, want = (attention.attention_apply(layer.attn, a_in, layer.acfg,
                                                positions=positions, impl=impl)[0]
                     for impl in ("auto", "torch"))
        _tally(out, "attention output", got, want, LAYER_TOL)

    hooks = [layer.register_forward_pre_hook(layer_input, with_kwargs=True)
             for layer in model.layers]
    try:
        with torch.no_grad():
            caches = init_caches(model.cfg, seq.shape[0], seq.shape[1], torch.float32, seq.device)
            model.hidden(seq, caches=caches, attn_impl="torch")
            del caches
    finally:
        for hook in hooks:
            hook.remove()
    return out


def _plain_attention(q, k, v, causal):
    from repro_torch.kernels.flash_attention import flash_attention

    return flash_attention(q, k, v, causal=causal, impl="torch")


def moe_generate(tag, model, prompts, new: int, device, gpu: str, *, controls: bool) -> dict:
    """One timed ``Server.generate`` of an MoE model (flash once a layer in
    the prefill), teacher forced through the plain attention; with
    ``controls`` the two known-wrong attentions must be refused."""
    import torch

    from repro_torch import kernels
    from repro_torch.serve import Server

    cfg = model.cfg
    B, P = prompts.shape
    server = Server(cfg, model, device=device)
    server.generate(prompts[::-1].copy(), max_new_tokens=2)     # warm-up at the full prompt
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    records: list = []
    with routing_recorded(records):
        tokens, step_logits = server.generate(prompts, max_new_tokens=new, return_logits=True)
    counts = kernels.launch_counts()            # the MoE serving path ends here
    routing = served_routing(records, cfg.num_layers, B)
    del records
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = dict(server.last_stats)
    phase(f"{tag} serve", t0, f"Server.generate {B} x {P} + {new}; launches {json.dumps(counts)}")
    check(counts["flash_attention"] == cfg.num_layers,
          f"{tag}: flash launched {counts['flash_attention']} times, not {cfg.num_layers}")
    check(sum(v for k, v in counts.items() if k != "flash_attention") == 0,
          f"{tag}: kernels beside flash {counts}")
    check(tokens.shape == (B, P + new), f"{tag}: tokens {tokens.shape}")
    check(bool((tokens[:, :P] == prompts).all()), f"{tag}: the prompts came back changed")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"{tag}: token ids out of range")
    check(bool(torch.isfinite(step_logits).all()), f"{tag}: served logits are not finite")
    t0 = time.perf_counter()
    tf = moe_teacher_forced(model, tokens, step_logits, routing)
    del step_logits, routing
    layers = moe_layer_by_layer(model, tokens)["attention output"]
    # the floor: the same served run with no kernel at all (the plain
    # attention in the prefill too), teacher forced the same way
    frecords: list = []
    with attention_replaced(_plain_attention):
        with routing_recorded(frecords):
            ftokens, flogits = server.generate(prompts, max_new_tokens=new, return_logits=True)
        floor = moe_teacher_forced(model, ftokens, flogits,
                                   served_routing(frecords, cfg.num_layers, B))
    del frecords, flogits
    phase(f"{tag} teacher forcing", t0, f"{json.dumps(tf)}; with no kernel: {json.dumps(floor)}"
          f" (tolerance {TF_TOL} (1 + |b|)); layer by layer {json.dumps(layers)}")
    check(layers["bad"] == 0, f"{tag}: {layers['bad']} attention outputs beyond LAYER_TOL"
          f" (largest deviation {layers['max_abs_err']:.4g})")
    for part in ("served", "sequence"):
        check(tf[part]["bad"] <= MOE_TF_RATE[part] * tf[part]["logits"],
              f"{tag}: {tf[part]['bad']} of {tf[part]['logits']} {part} logits beyond the"
              f" teacher-forced tolerance, more than {MOE_TF_RATE[part]} of them (largest"
              f" deviation {tf[part]['max_abs_err']:.4g})")
    refusals = {}
    if controls:
        t0 = time.perf_counter()
        for name, stand_in in CONTROLS.items():
            crecords: list = []
            with attention_replaced(stand_in):
                with routing_recorded(crecords):
                    ctokens, clogits = server.generate(prompts, max_new_tokens=new,
                                                       return_logits=True)
                refusals[name] = moe_teacher_forced(
                    model, ctokens, clogits, served_routing(crecords, cfg.num_layers, B))
                refusals[name]["layers"] = moe_layer_by_layer(model, ctokens)["attention output"]
            del crecords, clogits
            c = refusals[name]
            check(c["layers"]["bad"] > 0
                  and c["sequence"]["bad"] > MOE_TF_RATE["sequence"] * c["sequence"]["logits"],
                  f"{tag}: the checks passed {name} attention: {json.dumps(c)}")
        phase(f"{tag} controls", t0, json.dumps(refusals))
    decode_tps = B * (new - 1) / stats["decode_s"]
    profile = None
    if controls:   # the full-depth model: where its time goes
        torch.cuda.empty_cache()
        profile = serve_profile(tag, model, server, prompts, new, stats, peak_gb, gpu)
    else:
        for line in (f"prefill seconds {stats['prefill_s']:.4f}",
                     f"time to first token {stats['first_token_s']:.4f} s",
                     f"decode tokens/s {decode_tps:.1f} ({B} x {new - 1} tokens"
                     f" in {stats['decode_s']:.4f} s)",
                     f"peak device memory {peak_gb:.3f} GB"):
            print(f"serve {cfg.name} ({cfg.num_layers} layers) {B} x {P} + {new}: {line}"
                  f" [{gpu}]", flush=True)
    del server
    torch.cuda.empty_cache()
    return {"counts": counts, "profile": profile, "prefill_s": stats["prefill_s"],
            "first_token_s": stats["first_token_s"], "decode_s": stats["decode_s"],
            "decode_tokens_per_s": decode_tps, "peak_gb": peak_gb, "teacher_forced": tf,
            "no_kernel_floor": floor, "layer_by_layer": layers, "controls": refusals}


def moe_serving(args, device, gpu: str) -> dict:
    """granite-moe-3b-a800m at full width and depth (32 layers, d_model
    1536, 40 experts top-8, random weights from the seed) served at the
    dense path's sizes with the controls; then qwen3-moe-30b-a3b at full
    width and MOE_BIG_LAYERS of its 48 layers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import MoELM

    rng = np.random.default_rng(args.seed)
    out = {}
    for tag, cfg, (B, P, new), controls in (
            ("moe", ARCHS[MOE_ARCH], (SERVE_BATCH, SERVE_PROMPT, SERVE_NEW), True),
            ("moe big", dataclasses.replace(ARCHS[MOE_BIG_ARCH], num_layers=MOE_BIG_LAYERS),
             (MOE_BIG_BATCH, MOE_BIG_PROMPT, MOE_BIG_NEW), False)):
        t0 = time.perf_counter()
        model = MoELM(cfg, device=device, seed=args.seed)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        cut = "" if cfg.num_layers == ARCHS[cfg.name].num_layers else (
            f"; depth cut to {cfg.num_layers} of {ARCHS[cfg.name].num_layers} layers (its"
            f" {ARCHS[cfg.name].num_layers} layers' float32 weights would not fit the card)")
        phase(f"{tag} model", t0, f"{cfg.name}: {n_params:,} float32 parameters"
              f" ({4 * n_params / 1e9:.3f} GB), {cfg.num_experts} experts top"
              f" {cfg.num_experts_per_token}, d_model {cfg.d_model}, seed {args.seed}{cut}")
        prompts = rng.integers(0, cfg.vocab_size, (B, P), np.int32)
        got = moe_generate(tag, model, prompts, new, device, gpu, controls=controls)
        got.update(params=n_params, weight_gb=4 * n_params / 1e9, layers=cfg.num_layers,
                   shape=[B, P, new])
        print(f"serve {cfg.name}: {n_params:,} parameters, {4 * n_params / 1e9:.3f} GB,"
              f" prefill {got['prefill_s']:.4f} s, first token {got['first_token_s']:.4f} s,"
              f" decode {got['decode_tokens_per_s']:.1f} tokens/s [{gpu}]", flush=True)
        out[cfg.name] = got
        del model
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Training: the flash backward kernel, llama3.2-1b and hubert-xlarge
# ---------------------------------------------------------------------------

TRAIN_ARCH = "llama3.2-1b"
ENC_ARCH = "hubert-xlarge"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 8, 2048, 20, 2, 3e-4
TRAIN_SEQUENCES, TRAIN_BLOCKS = 256, 16     # the corpus: N % (P * K) == 0 at P = K = 16
# llama3.2-1b trains on the drifting corpus, as launch/train.py feeds it:
# each sequence's Zipf ranking is rotated by its place in the corpus, so
# until the loader's epoch wraps (256 sequences, 32 steps of 8) nearly every
# batch's frequent tokens are ones no earlier batch made frequent, and 20
# steps leave its loss near where it starts.  That run is held to stay
# stable; a second run from the same initial state on the corpus without
# drift is held to learn.
DRIFT_RISE = 0.1        # gate: the mean of the drift run's last 5 losses at most the first's + this
LOSS_DROP = 1.0         # gate: a learning run's last loss below its first by this many nats
# the flat + seq-chunked step against the grouped step: |loss difference|
# (5e-7 on the H100) and each gradient leaf's relative L2 distance (0.0041;
# the card tests' gate for the flash backward's gradients)
FLAT_LOSS_TOL, FLAT_GRAD_TOL = 1e-4, 3e-2
FLAT_OVERRIDES = {"flat_attention": True, "loss_seq_chunks": 16}   # launch/dryrun.py:88
ENC_NOISE = 0.5         # hubert's frames: a seeded embedding of the targets plus this noise
ENC_MASK = 0.3          # the share of masked positions, as concrete_inputs draws it
RESTART_LAYERS, RESTART_STEPS, RESTART_AT = 2, 4, 2
BWD_TOL = FLASH_TOL["bfloat16"]   # |a - b| <= tol (1 + |b|), the bf16 forward's gate
LSE_TOL = 1e-5
BWD_CASES = {
    # name: (B, H, Hkv, S, D, causal); D is padded to the kernel's width
    "llama3.2-1b train": (8, 32, 8, 2048, 64, True),
    "hubert-xlarge train": (8, 16, 16, 2048, 80, False),
}


def bwd_inputs(case: str, device, seed: int):
    """q, k, v, dout at a training shape as the attention layer hands them
    to the kernel: views of [B, S, heads, D], zero-padded to the kernel's
    head dim where it has no instance at D (none since the kernels take
    hubert's 80; dout's padded columns zero as autograd gives them); the
    scale is the unpadded D's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import padded_head_dim

    B, H, Hkv, S, D, causal = BWD_CASES[case]
    Dp = padded_head_dim(D)
    g = torch.Generator(device=device).manual_seed(seed)

    def make(h):
        t = torch.randn((B, S, h, D), generator=g, device=device).bfloat16().transpose(1, 2)
        return t if Dp == D else F.pad(t, (0, Dp - D))

    q, k, v, dout = make(H), make(Hkv), make(Hkv), make(H)
    return q, k, v, dout, causal, 1.0 / D**0.5


def _beyond(got, want, tol: float) -> int:
    return int(((got.float() - want.float()).abs() > tol * (1 + want.float().abs())).sum())


def flash_bwd_parity(args, device) -> float:
    """The backward kernel against its plain version (the port of the
    reference's custom VJP) on the same inputs, output and statistics at
    llama3.2-1b's and hubert-xlarge's training shapes, its two known-wrong
    controls refused; the forward with lse equal to the one without and lse
    within LSE_TOL (1 + |b|) of the plain statistics; the same gradients
    through ``FlashAttention`` at hubert's unpadded D; returns the largest
    absolute deviation."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_cuda,
        flash_attention_stats, log_sum_exp)
    from repro_torch.kernels.flash_attention.ops import padded_head_dim

    worst = 0.0
    for i, case in enumerate(BWD_CASES):
        q, k, v, dout, causal, scale = bwd_inputs(case, device, args.seed + 60 + i)
        out32, (m, l) = flash_attention_stats(q, k, v, causal=causal, scale=scale)
        out, lse = out32.bfloat16(), log_sum_exp(m, l)
        del out32
        want = flash_attention_bwd_plain(q, k, v, out, dout, m, l, causal=causal, scale=scale)
        got = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=causal, scale=scale)
        again = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=causal, scale=scale)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
            bad = _beyond(a, b, BWD_TOL)
            errs[name] = float((a.float() - b.float()).abs().max())
            check(a.shape == b.shape and a.dtype == torch.bfloat16, f"flash bwd {case} {name}")
            check(bool(torch.isfinite(a).all()), f"flash bwd {case}: non-finite {name}")
            check(bad == 0, f"flash bwd {case}: {bad} {name} values beyond {BWD_TOL} (1 + |b|)"
                  f" (largest deviation {errs[name]:.3g})")
            check(torch.equal(a, c), f"flash bwd {case}: {name} differs between two calls")
            D = BWD_CASES[case][4]
            check(bool((a[..., D:] == 0).all()), f"flash bwd {case}: padded {name} not zero")
        worst = max(worst, *errs.values())
        # known-wrong controls: Dvec dropped (the output zeroed), dK and dV
        # summed into the wrong kv head
        no_dvec = flash_attention_bwd_cuda(q, k, v, torch.zeros_like(out), dout, lse,
                                           causal=causal, scale=scale)
        refused = {"no Dvec": sum(_beyond(a, b, BWD_TOL) for a, b in zip(no_dvec, want)),
                   "wrong group": sum(_beyond(a.roll(1, dims=1), b, BWD_TOL)
                                      for a, b in zip(got[1:], want[1:]))}
        for name, n in refused.items():
            check(n > 0, f"flash bwd {case}: the gate passed the known-wrong '{name}' control")
        del no_dvec, want, again
        # the forward's lse: the output unchanged, lse the plain statistics
        o_lse, lse_k = flash_attention_cuda(q, k, v, causal=causal, scale=scale, with_lse=True)
        o = flash_attention_cuda(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        check(torch.equal(o, o_lse), f"flash {case}: the output with lse differs from without")
        lse_err = float((lse_k - lse).abs().max())
        lse_bad = _beyond(lse_k, lse, LSE_TOL)
        check(lse_bad == 0, f"flash {case}: {lse_bad} lse values beyond {LSE_TOL} (1 + |b|)"
              f" (largest {lse_err:.3g})")
        print(f"  flash bwd {case}: max |kernel - plain| {json.dumps(errs)} (tolerance {BWD_TOL}"
              f" (1 + |b|)); controls refused by {json.dumps(refused)} values; lse max"
              f" |kernel - plain| {lse_err:.3g}", flush=True)
        del q, k, v, dout, out, lse, got, o, o_lse, lse_k, m, l
        torch.cuda.empty_cache()

    # through FlashAttention at hubert's D = 80, which both kernels take as it
    # is (no padding), against the plain Function
    B, H, Hkv, S, D, causal = BWD_CASES["hubert-xlarge train"]
    check(padded_head_dim(D) == D, f"the kernels pad hubert's D = {D} to {padded_head_dim(D)}")
    g = torch.Generator(device=device).manual_seed(args.seed + 70)
    q, k, v, dout = (torch.randn((B, h, S, D), generator=g, device=device).bfloat16()
                     for h in (H, Hkv, Hkv, H))
    grads = {}
    for impl in ("auto", "torch"):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        kernels.reset_launch_counts()
        flash_attention(*ins, causal=causal, impl=impl).backward(dout)
        counts = kernels.launch_counts()
        grads[impl] = [t.grad for t in ins]
        if impl == "auto":
            check(counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1,
                  f"FlashAttention at D = 80 launched {counts}")
    bad = sum(_beyond(a, b, BWD_TOL) for a, b in zip(grads["auto"], grads["torch"]))
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*grads.values()))
    check(bad == 0, f"FlashAttention at D = 80: {bad} gradient values beyond {BWD_TOL}")
    print(f"  FlashAttention at D = 80 (the kernels' own width): max |kernel - plain| {err:.3g}",
          flush=True)
    del q, k, v, dout, grads
    torch.cuda.empty_cache()
    return max(worst, err)


def flash_bwd_times(args, device, case: str) -> dict:
    """The backward kernel at a training shape beside its bound, its plain
    version and the backward of one ``scaled_dot_product_attention`` call
    on head-expanded K/V (the forward's yardstick)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        BWD_KERNELS, flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_stats,
        log_sum_exp)

    q, k, v, dout, causal, scale = bwd_inputs(case, device, args.seed + 80)
    B, H, S, Dp = q.shape
    Hkv, D = k.shape[1], BWD_CASES[case][4]
    out32, (m, l) = flash_attention_stats(q, k, v, causal=causal, scale=scale)
    out, lse = out32.bfloat16(), log_sum_exp(m, l)
    del out32
    pairs = S * (S + 1) // 2 if causal else S * S

    def work(d):
        # 2.5x the forward's 4 B H d pairs; q, k, v, out, dout read and dq,
        # dk, dv written once in bf16, lse read in float32
        return 10 * B * H * d * pairs, 2 * d * (4 * B * H * S + 4 * B * Hkv * S) + 4 * lse.numel()

    # the function's work is at the unpadded D (the padded columns are
    # zeros); the kernel's at Dp, the padding's cost beside it
    flops, nbytes = work(D)
    b, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
    padded_flops, padded_bytes = work(Dp)
    run = lambda i: flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=causal,  # noqa: E731
                                             scale=scale)
    # the library's call at the unpadded D, which it takes as it is
    qr = q[..., :D].contiguous().requires_grad_()
    ke = k[..., :D].repeat_interleave(H // Hkv, dim=1).contiguous().requires_grad_()
    ve = v[..., :D].repeat_interleave(H // Hkv, dim=1).contiguous().requires_grad_()
    lib_dout = dout[..., :D].contiguous()
    lib_out = F.scaled_dot_product_attention(qr, ke, ve, is_causal=causal, scale=scale)
    got = {
        "ms": time_cuda(run, reps=REPS),
        "plain_ms": time_cuda(lambda i: flash_attention_bwd_plain(
            q, k, v, out, dout, m, l, causal=causal, scale=scale), reps=2),
        "library_ms": time_cuda(lambda i: torch.autograd.grad(
            lib_out, (qr, ke, ve), lib_dout, retain_graph=True), reps=REPS),
        "device_ms": device_ms(run, REPS, *BWD_KERNELS),
        "bound_ms": b, "bound_by": by, "flops": flops, "bytes": nbytes,
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": flops / BF16_OPS_PER_S * 1e3,
        "padded_bound_ms": bound_ms(padded_bytes, padded_flops, BF16_OPS_PER_S)[0],
        "kernels_per_call": len(BWD_KERNELS),
        "shape": f"q, out, dout [{B}, {H}, {S}, {D}], k/v [{B}, {Hkv}, {S}, {D}] bf16"
                 f"{'' if D == Dp else f' padded to {Dp}'},"
                 f" {'causal' if causal else 'full'}, lse f32",
    }
    del q, k, v, dout, out, lse, m, l, qr, ke, ve, lib_dout, lib_out
    torch.cuda.empty_cache()
    return got


def train_flops(cfg, batch: int, seq: int) -> int:
    """A training step's operations before remat: three times the forward's
    (every projection over every token, attention over its pairs, the
    unembedding or head at every position)."""
    d, dh, T = cfg.d_model, cfg.resolved_head_dim, batch * seq
    proj = d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = (2 if cfg.family == "encoder" or cfg.mlp_type == "gelu" else 3) * d * cfg.d_ff
    pairs = seq * (seq + 1) // 2 if cfg.causal else seq * seq
    attn = 4 * cfg.num_heads * dh * pairs * batch
    ends = 2 * d * cfg.vocab_size * T + (2 * d * d * T if cfg.family == "encoder" else 0)
    return 3 * (cfg.num_layers * (2 * (proj + mlp) * T + attn) + ends)


def token_loader(vocab: int, seq: int, seed: int, device, drift: bool):
    """The Zipf token corpus (``drift``: the drifting one) in RSP blocks
    (Algorithm 1) and the RSP loader over them, batches of TRAIN_BATCH
    sequences on ``device``."""
    from repro_torch.core import RSPSpec, two_stage_partition_np
    from repro_torch.data import BlockSource, RSPLoader, make_token_corpus

    corpus = make_token_corpus(TRAIN_SEQUENCES, seq, vocab_size=vocab, seed=seed, drift=drift)
    spec = RSPSpec(num_records=TRAIN_SEQUENCES, num_blocks=TRAIN_BLOCKS,
                   num_original_blocks=TRAIN_BLOCKS, seed=1)
    blocks = two_stage_partition_np(corpus, spec)
    return RSPLoader(BlockSource(blocks=blocks, device=device), batch_size=TRAIN_BATCH, seed=5)


def trained(tag: str, cfg, state, loader, transform, device, gpu: str, ckpt_dir: str,
            seed: int, gate: str = "drop", *, steps: int = TRAIN_STEPS,
            warmup: int = TRAIN_WARMUP, launches: dict | None = None,
            bound_s: float | None = None):
    """``steps`` steps of the Trainer from ``state`` (``warmup`` of them
    warming the rate up), every step logged:
    its losses, step seconds (synchronised), tokens/s, share of the bf16
    peak (``bound_s``, the step's least time, over the step; by default
    ``train_flops`` at the bf16 peak), peak memory and launches a step,
    printed beside the card.  Every loss and gradient norm must be finite,
    and each kernel launched ``launches`` (counter -> launches a step;
    by default flash's, twice a layer forward and once backward) times a
    step; ``gate``: "drop", the loss must fall by LOSS_DROP; "stable", the
    mean of the last five stay within DRIFT_RISE of the first; "tail3",
    the mean of the last three lie below the first."""
    import math
    import statistics as st

    import torch

    from repro_torch import kernels
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    tc = TrainConfig(total_steps=steps, warmup_steps=warmup, log_every=1,
                     checkpoint_every=10**9, seed=seed)
    trainer = Trainer(cfg, AdamWConfig(lr=TRAIN_LR), tc, loader, ckpt_dir, device=device,
                      batch_transform=transform)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.run(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()          # the training path ends here
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    step_s = st.median(h["sec_per_step"] for h in hist[1:])
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    if bound_s is None:
        bound_s = flops / BF16_OPS_PER_S
    L = cfg.num_layers
    if launches is None:
        launches = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    out = {
        "steps": len(hist), "losses": losses, "first_step_s": hist[0]["sec_per_step"],
        "step_s": step_s, "step_s_all": [h["sec_per_step"] for h in hist],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "flops_per_step": flops,
        "bound_step_s": bound_s, "peak_share": bound_s / step_s,
        "peak_gb": peak_gb, "wall_s": wall, "counts": counts,
        "launches_per_step": {k: counts[k] / len(hist) for k in launches},
        "grad_norms": [h["grad_norm"] for h in hist], "lrs": [h["lr"] for h in hist],
    }
    phase(f"{tag} train", t0, f"{len(hist)} steps of {TRAIN_BATCH} x {TRAIN_SEQ}; launches"
          f" {json.dumps(counts)}")
    for line in (f"losses {losses[0]:.4f} -> {losses[-1]:.4f}"
                 f" ({json.dumps([round(x, 4) for x in losses])}), gradient norms"
                 f" {json.dumps([round(x, 4) for x in out['grad_norms']])}",
                 f"step seconds {step_s:.4f} (median of steps 2-{len(hist)}; first"
                 f" {hist[0]['sec_per_step']:.4f})",
                 f"tokens/s {out['tokens_per_s']:.1f}",
                 f"share of the peak {out['peak_share']:.4f} (a bound of"
                 f" {out['bound_step_s']:.4f} s a step before remat)",
                 f"peak device memory {peak_gb:.3f} GB",
                 f"launches a step: {json.dumps(out['launches_per_step'])}"):
        print(f"train {tag} ({cfg.name}) {TRAIN_BATCH} x {TRAIN_SEQ}: {line} [{gpu}]", flush=True)
    check(all(counts[k] == len(hist) * n for k, n in launches.items()),
          f"{tag}: {counts} launches in {len(hist)} steps, not {launches} a step")
    check(all(math.isfinite(x) for x in losses), f"{tag}: a loss is not finite: {losses}")
    check(all(math.isfinite(x) for x in out["grad_norms"]),
          f"{tag}: a gradient norm is not finite: {out['grad_norms']}")
    if gate == "drop":
        check(losses[-1] < losses[0] - LOSS_DROP, f"{tag}: the loss fell from {losses[0]:.4f}"
              f" to {losses[-1]:.4f}, not by {LOSS_DROP}")
    elif gate == "stable":
        tail = st.mean(losses[-5:])
        check(tail <= losses[0] + DRIFT_RISE, f"{tag}: the last five losses average {tail:.4f},"
              f" above the first {losses[0]:.4f} + {DRIFT_RISE}")
    else:
        tail = st.mean(losses[-3:])
        check(tail < losses[0], f"{tag}: the last three losses average {tail:.4f}, not below"
              f" the first {losses[0]:.4f}")
    return state, out


def step_grads(cfg, state, batch, device):
    """One step's loss and gradients (no optimizer) and its peak memory."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.transformer import build_lm
    from repro_torch.train import param_grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = build_lm(cfg, state["params"], device=device, trainable=True)
    loss, _ = api.make_loss_fn(model)(batch)
    loss.backward()
    grads = param_grads(model, state["params"])
    del model
    torch.cuda.synchronize()
    return float(loss.detach()), grads, torch.cuda.max_memory_allocated(device) / 1e9, \
        time.perf_counter() - t0


def profiled_step(tag: str, cfg, state, batch, device, expect: dict | None = None) -> dict:
    """One forward and backward of ``cfg`` (no optimizer) under the
    profiler, after PROFILER_WARMUP fills (the profiler misses a session's
    first device events): the device's busy and idle share, the top device
    items and the device events of each of the backward's kernels, which
    must be ``expect`` (device kernel -> events; by default each of
    flash's backward kernels once a layer)."""
    import torch

    from repro_torch.kernels.flash_attention import BWD_KERNELS

    if expect is None:
        expect = {k: cfg.num_layers for k in BWD_KERNELS}
    scratch = torch.empty(1, dtype=torch.int16, device=device)

    def run():
        for _ in range(PROFILER_WARMUP):
            scratch.fill_(0)
        torch.cuda.synchronize()
        time.sleep(0.05)
        step_grads(cfg, state, batch, device)

    counts = {}
    wall, busy, by_name, n_events = profiled(run, counts)
    seen = {k: sum(n for name, n in counts.items() if k in name) for k in expect}
    prof = {
        "wall_s": wall, "device_busy_s": busy, "device_events": n_events,
        "idle_share": None if busy is None else 1 - busy / wall,
        "bwd_kernel_events": seen,
        "bwd_kernel_s": {k: sum(sec for name, sec in by_name.items() if k in name)
                         for k in expect},
        "top": [(name[:60], sec) for name, sec in sorted(by_name.items(),
                                                         key=lambda kv: -kv[1])[:10]]}
    check(seen == expect, f"{tag}: a profiled step's backward kernels ran {seen} times, not"
          f" {expect}")
    torch.cuda.empty_cache()
    return prof


def restart_gate(args, device, tmp: str) -> dict:
    """RESTART_STEPS steps unbroken, and RESTART_AT steps, a checkpoint, a
    fresh Trainer and the rest: the resumed master weights, moments and
    step equal the unbroken run's bit for bit, under
    ``torch.use_deterministic_algorithms(True)`` (ops without a
    deterministic CUDA version are named from its warnings).  llama3.2-1b
    at full width and RESTART_LAYERS layers."""
    import dataclasses
    import os
    import shutil
    import warnings

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.configs import ARCHS
    from repro_torch.models.common import iter_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer, init_state

    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], num_layers=RESTART_LAYERS)
    tc = TrainConfig(total_steps=RESTART_STEPS, warmup_steps=1, log_every=1,
                     checkpoint_every=10**9, seed=args.seed)
    transform = lambda b: {"tokens": b.to(torch.int32)}  # noqa: E731

    def trainer(ckpt_dir):
        loader = token_loader(cfg.vocab_size, TRAIN_SEQ + 1, args.seed, device, True)
        return Trainer(cfg, AdamWConfig(lr=TRAIN_LR), tc, loader, ckpt_dir, device=device,
                       batch_transform=transform)

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            whole = trainer(os.path.join(tmp, "whole")).run(init_state(cfg, args.seed,
                                                                      device=device))
            part = os.path.join(tmp, "resumed")
            trainer(part).run(init_state(cfg, args.seed, device=device),
                              stop_after_steps=RESTART_AT)
            ckpt = os.path.join(part, f"step_{RESTART_AT:08d}")
            written = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
            free = shutil.disk_usage(part).free
            torch.cuda.empty_cache()
            resumed = trainer(part).run()
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0] for w in caught
                     if "deterministic" in str(w.message)})
    pairs = [(p, a, b) for part_ in ("master", "m", "v", "step")
             for (p, a), (_, b) in zip(iter_leaves({part_: whole["opt"][part_]}),
                                       iter_leaves({part_: resumed["opt"][part_]}))]
    differ = [("/".join(p), float((a.float() - b.float()).abs().max()))
              for p, a, b in pairs if not torch.equal(a, b)]
    got = {"layers": RESTART_LAYERS, "steps": RESTART_STEPS, "checkpoint_at": RESTART_AT,
           "bytes_written": written, "free_disk_bytes": free,
           "step": [int(whole["opt"]["step"]), int(resumed["opt"]["step"])],
           "leaves": len(pairs), "leaves_differing": differ, "nondeterministic_ops": nondet,
           "latest": store.latest_step(part)}
    phase("restart gate", t0, json.dumps(got))
    check(got["step"] == [RESTART_STEPS, RESTART_STEPS], f"restart gate steps {got['step']}")
    check(not differ, f"the resumed run differs from the unbroken one in {differ}"
          f" (ops without a deterministic version: {nondet})")
    del whole, resumed
    torch.cuda.empty_cache()
    return got


def training(args, device, gpu: str) -> dict:
    """llama3.2-1b at full width and depth trained TRAIN_STEPS steps on the
    drifting Zipf token corpus in RSP blocks; one step of its state under
    the flat + seq-chunked overrides against the grouped step; TRAIN_STEPS
    steps from the same initial state on the corpus without drift;
    hubert-xlarge's forward and TRAIN_STEPS training steps; the restart
    gate."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import iter_leaves
    from repro_torch.models.transformer import build_lm
    from repro_torch.train import init_state

    out = {}
    tmp = tempfile.mkdtemp(prefix="rsp_train_")
    try:
        # llama3.2-1b, as launch/train.py --preset full builds it
        cfg = ARCHS[TRAIN_ARCH]
        t0 = time.perf_counter()
        loader = token_loader(cfg.vocab_size, TRAIN_SEQ + 1, args.seed, device, True)
        state = init_state(cfg, args.seed, device=device)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for _, p in iter_leaves(state["params"]))
        phase("train setup", t0, f"{cfg.name}: {n_params:,} parameters, bf16 params + float32"
              f" master, m and v {n_params * 14 / 1e9:.3f} GB; corpus {TRAIN_SEQUENCES} x"
              f" {TRAIN_SEQ + 1} tokens in {TRAIN_BLOCKS} RSP blocks")
        transform = lambda b: {"tokens": b.to(torch.int32)}  # noqa: E731
        state, out["llama"] = trained("llama", cfg, state, loader, transform, device, gpu, tmp,
                                      args.seed, "stable")

        # one step of the trained state, grouped and flat + seq-chunked
        batch = transform(loader.next_batch())
        loader.close()
        steps = {}
        for tag, c in (("grouped", cfg), ("flat + seq-chunked",
                                          dataclasses.replace(cfg, **FLAT_OVERRIDES))):
            kernels.reset_launch_counts()
            loss, grads, peak, secs = step_grads(c, state, batch, device)
            steps[tag] = {"loss": loss, "peak_gb": peak, "s": secs,
                          "counts": kernels.launch_counts()}
            if tag == "grouped":
                ref_grads = grads
            else:
                rel = max(float((a.float() - b.float()).norm() / b.float().norm())
                          for (_, a), (_, b) in zip(iter_leaves(grads), iter_leaves(ref_grads)))
                steps[tag]["grad_rel_l2_max"] = rel
            del grads
            torch.cuda.empty_cache()
        del ref_grads
        # where a step's device time goes: one profiled grouped forward and
        # backward (the optimizer's update is not in it)
        steps["grouped"]["profile"] = profiled_step("llama", cfg, state, batch, device)
        d = abs(steps["flat + seq-chunked"]["loss"] - steps["grouped"]["loss"])
        drop = steps["grouped"]["peak_gb"] - steps["flat + seq-chunked"]["peak_gb"]
        phase("train flat step", t0, f"{json.dumps(steps)}; |loss difference| {d:.3g}"
              f" (tolerance {FLAT_LOSS_TOL}), largest gradient relative L2"
              f" {steps['flat + seq-chunked']['grad_rel_l2_max']:.3g} (tolerance {FLAT_GRAD_TOL}),"
              f" peak memory lower by {drop:.3f} GB")
        print(f"train {cfg.name} one step, flat + loss_seq_chunks 16 against grouped: loss"
              f" {steps['flat + seq-chunked']['loss']:.5f} against {steps['grouped']['loss']:.5f},"
              f" peak {steps['flat + seq-chunked']['peak_gb']:.3f} against"
              f" {steps['grouped']['peak_gb']:.3f} GB [{gpu}]", flush=True)
        check(d <= FLAT_LOSS_TOL, f"the flat + seq-chunked step's loss is {d:.3g} from the"
              f" grouped step's")
        rel = steps["flat + seq-chunked"]["grad_rel_l2_max"]
        check(rel <= FLAT_GRAD_TOL, f"a flat + seq-chunked gradient leaf is {rel:.3g} (relative"
              f" L2) from the grouped step's, beyond {FLAT_GRAD_TOL}")
        check(drop > 0, f"the flat + seq-chunked step's peak memory is not lower ({drop:.3f} GB)")
        out["flat_step"] = dict(steps, loss_difference=d, peak_drop_gb=drop)
        del state, batch
        torch.cuda.empty_cache()

        # the same initial state on the corpus without drift: it learns
        loader = token_loader(cfg.vocab_size, TRAIN_SEQ + 1, args.seed, device, False)
        out["llama_no_drift"] = trained("llama no drift", cfg,
                                        init_state(cfg, args.seed, device=device), loader,
                                        transform, device, gpu, tmp, args.seed)[1]
        loader.close()
        torch.cuda.empty_cache()

        # hubert-xlarge: frames are a fixed seeded embedding of RSP-sampled
        # target ids plus noise, 30% of the positions masked
        cfg = ARCHS[ENC_ARCH]
        t0 = time.perf_counter()
        loader = token_loader(cfg.vocab_size, TRAIN_SEQ, args.seed + 1, device, True)
        gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=device)

        def frames_of(targets):
            noise = torch.randn((*targets.shape, cfg.d_model), generator=gen, device=device)
            return {"frames": (table[targets.long()] + ENC_NOISE * noise).bfloat16(),
                    "targets": targets.to(torch.int32),
                    "mask": torch.rand(targets.shape, generator=gen, device=device) < ENC_MASK}

        state = init_state(cfg, args.seed, device=device)
        batch = frames_of(loader.next_batch())
        model = build_lm(cfg, state["params"], device=device, trainable=True)
        with torch.no_grad():
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = api.make_forward_fn(model)({"frames": batch["frames"]})
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t1
            fcounts = kernels.launch_counts()
            plain = model(batch["frames"], attn_impl="torch")
        dev_ = logit_deviation(logits, plain)
        enc_fwd = {"s": fwd_s, "counts": fcounts, "shape": list(logits.shape),
                   "against_plain": dev_}
        phase("hubert forward", t0, json.dumps(enc_fwd))
        check(fcounts["flash_attention"] == cfg.num_layers and fcounts["flash_attention_bwd"] == 0,
              f"hubert's forward launched {fcounts}")
        check(list(logits.shape) == [TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size]
              and bool(torch.isfinite(logits).all()), "hubert's logits")
        check(dev_["bad"] == 0, f"hubert's forward: {dev_['bad']} logits beyond {TF_TOL}"
              f" (1 + |b|) of the plain attention's (largest {dev_['max_abs_err']:.4g})")
        del model, logits, plain, batch
        state, out["hubert"] = trained("hubert", cfg, state, loader, frames_of, device, gpu,
                                       tmp, args.seed)
        out["hubert"]["forward"] = enc_fwd
        out["hubert"]["profile"] = profiled_step("hubert", cfg, state,
                                                 frames_of(loader.next_batch()), device)
        print(f"train hubert ({cfg.name}): one profiled forward and backward:"
              f" {json.dumps(out['hubert']['profile'])} [{gpu}]", flush=True)
        loader.close()
        del state, table
        torch.cuda.empty_cache()

        out["restart"] = restart_gate(args, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 10b: the MoE, hybrid and RWKV6 families trained at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("rwkv6-1.6b", "zamba2-7b", "granite-moe-3b-a800m")
FAMILY_STEPS = 10
# zamba2-7b's first updates at the full rate take its loss from 11.07 to
# 14-16 and back (its gradient norm is 106 at the initial state, clipped
# to 1; the plain SSD's run follows the kernels' step for step): with 2
# warmup steps of 10 one run's last three losses averaged 12.27 against
# the first 11.07, with 5 they averaged 9.54 (H100 runs, PERF.md §6)
FAMILY_WARMUP = 5
# zamba2-7b's 81 layers hold 6,776,229,968 parameters, a 94.9 GB state at 14
# bytes a parameter; 24 (four rounds of a shared-block call and 6 Mamba2
# layers: the shared block keeps its place) hold 2,331,896,192, 32.6 GB
FAMILY_LAYERS = {"zamba2-7b": 24}
# one step with the kernels against the same step with the plain versions,
# on a cut with every kernel of the family (zamba2: one Mamba2 layer after
# one shared-block call), each gradient leaf within this relative L2
FAMILY_PARITY_LAYERS = {"rwkv6-1.6b": 2, "zamba2-7b": 1, "granite-moe-3b-a800m": 2}
FAMILY_GRAD_TOL = 3e-2
PLAIN_IMPLS = {"moe": {"attn_impl": "torch"},
               "hybrid": {"attn_impl": "torch", "ssd_impl": "torch"},
               "rwkv": {"wkv_impl": "torch"}}


def family_cfg(arch: str):
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch]
    return dataclasses.replace(cfg, num_layers=FAMILY_LAYERS[arch]) if arch in FAMILY_LAYERS \
        else cfg


def shared_calls(cfg) -> int:
    from repro_torch.models.transformer import hybrid_layout

    full, _, rem = hybrid_layout(cfg)
    return full + (1 if rem else 0)


def family_launches(cfg) -> dict:
    """Each kernel wrapper's launches a training step: the forward twice a
    layer (remat), the backward once."""
    L = cfg.num_layers
    if cfg.family == "rwkv":
        return {"rwkv6_wkv": 2 * L, "rwkv6_wkv_bwd": L}
    if cfg.family == "hybrid":
        inv = shared_calls(cfg)
        return {"mamba2_ssd": 2 * L, "mamba2_ssd_bwd": L, "flash_attention": 2 * inv,
                "flash_attention_bwd": inv}
    return {"flash_attention": 2 * L, "flash_attention_bwd": L}


def family_bwd_kernels(cfg) -> dict:
    """The backward's device kernels and their events in one step."""
    from repro_torch.kernels.flash_attention import BWD_KERNELS as FA
    from repro_torch.kernels.mamba2_ssd import BWD_KERNELS as SSD
    from repro_torch.kernels.rwkv6_wkv import BWD_KERNELS as WKV

    L = cfg.num_layers
    if cfg.family == "rwkv":
        return {k: L for k in WKV}
    if cfg.family == "hybrid":
        return {**{k: L for k in SSD}, **{k: shared_calls(cfg) for k in FA}}
    return {k: L for k in FA}


def family_train_ops(cfg, batch: int, seq: int) -> tuple[int, int]:
    """(bf16, float32) operations of a training step before remat: three
    times the forward's projections (2 a multiply-add) over every token,
    attention over its causal pairs and the unembedding at every position;
    the MoE's active experts (top-k of them a token) and float32 router;
    the hybrid's float32 dt projection; rwkv6's float32 low-rank products;
    and each scan's forward and backward once (``ssd_work`` and
    ``ssd_bwd_work``, ``wkv_work`` and ``wkv_bwd_work``)."""
    d, T, L = cfg.d_model, batch * seq, cfg.num_layers
    ends = 2 * d * cfg.vocab_size * T
    if cfg.family == "rwkv":
        bf16, f32 = rwkv_flops(cfg, batch, seq, every_position=True)
        scan = L * (wkv_work(batch, seq, cfg.num_heads)[0]
                    + wkv_bwd_work(batch, seq, cfg.num_heads)[0])
        return 3 * bf16, 3 * f32 + scan
    dh = cfg.resolved_head_dim
    proj = d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    attn = 4 * cfg.num_heads * dh * seq * (seq + 1) // 2 * batch
    if cfg.family == "hybrid":
        m = cfg.mamba_config()
        inv = shared_calls(cfg)
        shared = 2 * d * d + proj + 3 * d * cfg.d_ff
        mamba = d * (2 * m.d_inner + 2 * m.d_state) + m.d_inner * d
        bf16 = inv * (2 * shared * T + attn) + L * 2 * mamba * T + ends
        scan = L * (ssd_work(batch, seq, m.num_heads)[0] + ssd_bwd_work(batch, seq, m.num_heads)[0])
        return 3 * bf16, 3 * L * 2 * d * m.num_heads * T + scan
    experts = cfg.num_experts_per_token * 3 * d * cfg.d_ff
    bf16 = L * (2 * (proj + experts) * T + attn) + ends
    return 3 * bf16, 3 * L * 2 * d * cfg.num_experts * T


def family_loss(model, batch: dict, impls: dict):
    """``lm_loss`` with the given impls: the cross entropy of every
    position's logits plus the MoE's aux loss."""
    from repro_torch.models.common import softmax_cross_entropy

    tokens = batch["tokens"]
    h, _, aux = model.hidden_aux(tokens[:, :-1], **impls)
    return softmax_cross_entropy(model.logits(h), tokens[:, 1:]) + aux


def family_parity(tag: str, cfg, seed: int, batch: dict, device) -> dict:
    """One step's gradients of a fresh state at ``cfg`` with the kernels
    against the same step with the plain versions: each leaf within
    FAMILY_GRAD_TOL relative L2; the kernels launched in the first run and
    not in the second."""
    import torch

    from repro_torch import kernels
    from repro_torch.models.common import iter_leaves
    from repro_torch.models.transformer import build_lm
    from repro_torch.train import init_state, param_grads

    state = init_state(cfg, seed, device=device)
    grads, losses, counts = [], [], []
    for impls in ({}, PLAIN_IMPLS[cfg.family]):
        kernels.reset_launch_counts()
        model = build_lm(cfg, state["params"], device=device, trainable=True)
        loss = family_loss(model, batch, impls)
        loss.backward()
        grads.append(param_grads(model, state["params"]))
        losses.append(float(loss.detach()))
        counts.append({k: v for k, v in kernels.launch_counts().items() if v})
        del model, loss
        torch.cuda.empty_cache()
    def rel_l2(a, b):
        # a leaf with no gradient in the plain step (rwkv6's lora_a, whose
        # lora_b starts at zero) must have none with the kernels either
        den = float(b.float().norm())
        return float((a.float() - b.float()).norm()) / den if den else (
            0.0 if not a.any() else float("inf"))

    rel = {"/".join(p): rel_l2(a, b)
           for (p, a), (_, b) in zip(iter_leaves(grads[0]), iter_leaves(grads[1]))}
    worst = max(rel, key=rel.get)
    got = {"layers": cfg.num_layers, "loss": losses, "counts": counts,
           "grad_rel_l2_max": rel[worst], "worst_leaf": worst, "leaves": len(rel)}
    print(f"train {tag} ({cfg.name}, {cfg.num_layers} layers): one step with the kernels"
          f" against the plain versions: losses {losses[0]:.5f} and {losses[1]:.5f}, largest"
          f" gradient relative L2 {rel[worst]:.3g} ({worst}) of {len(rel)} leaves;"
          f" launches {json.dumps(counts)}", flush=True)
    expect = family_launches(cfg)
    check(all(counts[0].get(k, 0) > 0 for k in expect) and not counts[1],
          f"{tag}: the kernels' step launched {counts[0]}, the plain step {counts[1]}")
    check(rel[worst] <= FAMILY_GRAD_TOL, f"{tag}: gradient leaf {worst} is {rel[worst]:.3g}"
          f" (relative L2) from the plain versions' step, beyond {FAMILY_GRAD_TOL}")
    del state, grads
    torch.cuda.empty_cache()
    return got


def training_families(args, device, gpu: str) -> dict:
    """Phase 10b: rwkv6-1.6b (full width and depth), zamba2-7b (full width,
    FAMILY_LAYERS of its layers) and granite-moe-3b-a800m (full width and
    depth) trained FAMILY_STEPS Trainer steps of TRAIN_BATCH x TRAIN_SEQ on
    the token corpus without drift, as phase 10's learning run; each
    family's profiled step and its kernels-against-plain step."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.models.common import iter_leaves
    from repro_torch.train import init_state

    out = {}
    tmp = tempfile.mkdtemp(prefix="rsp_train_families_")
    transform = lambda b: {"tokens": b.to(torch.int32)}  # noqa: E731
    try:
        for arch in FAMILY_ARCHS:
            cfg = family_cfg(arch)
            tag = arch.split("-")[0]
            loader = token_loader(cfg.vocab_size, TRAIN_SEQ + 1, args.seed, device, False)
            # the kernels against the plain versions first, on a cut, with
            # a batch the training run does not see
            batch = transform(loader.next_batch())
            t0 = time.perf_counter()
            parity = family_parity(tag, dataclasses.replace(
                cfg, num_layers=FAMILY_PARITY_LAYERS[arch]), args.seed, batch, device)
            phase(f"{tag} kernels against plain", t0)
            t0 = time.perf_counter()
            state = init_state(cfg, args.seed, device=device)
            torch.cuda.synchronize()
            n_params = sum(p.numel() for _, p in iter_leaves(state["params"]))
            phase(f"{tag} train setup", t0, f"{cfg.name} at {cfg.num_layers} layers: {n_params:,}"
                  f" parameters, state {n_params * 14 / 1e9:.3f} GB")
            bf16, f32 = family_train_ops(cfg, TRAIN_BATCH, TRAIN_SEQ)
            bound_s = bf16 / BF16_OPS_PER_S + f32 / FP32_OPS_PER_S
            state, res = trained(tag, cfg, state, loader, transform, device, gpu, tmp, args.seed,
                                 "tail3", steps=FAMILY_STEPS, warmup=FAMILY_WARMUP,
                                 launches=family_launches(cfg), bound_s=bound_s)
            res.update(layers=cfg.num_layers, parameters=n_params, bf16_ops=bf16, fp32_ops=f32,
                       parity=parity)
            res["profile"] = profiled_step(tag, cfg, state, batch, device,
                                           expect=family_bwd_kernels(cfg))
            print(f"train {tag} ({cfg.name}): one profiled forward and backward:"
                  f" {json.dumps(res['profile'])} [{gpu}]", flush=True)
            loader.close()
            out[arch] = res
            del state, batch
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# the kernels redesigned for Hopper, by their names in the build log
REDESIGNED = {
    **{f"fa_wgmma_bf16<{d}>": f"fa_wgmma_bf16ILi{d}E" for d in (64, 80, 112, 128)},
    # the shuffle's default CTA sizes (the tuner's other sizes are built too)
    "rsp_shuffle_staged<u32, 1024>": "rsp_shuffle_stagedIjLi1024EE",
    "rsp_shuffle_staged<u16, 1024>": "rsp_shuffle_stagedItLi1024EE",
    "rsp_shuffle_rows<u32, 256>": "rsp_shuffle_rowsIjLi256EE",
    "rsp_shuffle_rows<u16, 256>": "rsp_shuffle_rowsItLi256EE",
    "ssd_state": "ssd_state", "ssd_scan": "ssd_scan", "wkv6_chunks": "wkv6_chunks",
    "block_sketch_fused<512>": "block_sketch_fusedILi512E",
    "plan_sketch_fused<512, G 1>": "plan_sketch_fusedILi512ELi1E",
    "plan_sketch_fused<512, G 2>": "plan_sketch_fusedILi512ELi2E",
    # the flash backward (wgmma + TMA): llama's D = 64, hubert's 80, 112, 128
    **{f"fa_bwd_{part}_wgmma<{d}>": f"fa_bwd_{part}_wgmmaILi{d}E" for part in ("dkdv", "dq")
       for d in (64, 80, 112, 128)},
}
# the scans' backward kernels (on the tensor cores), reported beside them, and
# the library function (and its kernel argument) that gives each one's
# dynamic shared memory
SCAN_BWD_KERNELS = {"ssd_bwd_state": "ssd_bwd_state", "ssd_bwd_tile": "ssd_bwd_tile",
                    "wkv6_bwd_state": "wkv6_bwd_state", "wkv6_bwd_chunk": "wkv6_bwd_chunk"}
SCAN_BWD_SMEM = {"ssd_bwd_state": ("mamba2_ssd_bwd_smem_bytes", 0),
                 "ssd_bwd_tile": ("mamba2_ssd_bwd_smem_bytes", 1),
                 "wkv6_bwd_state": ("rwkv6_wkv_bwd_smem_bytes", 0),
                 "wkv6_bwd_chunk": ("rwkv6_wkv_bwd_smem_bytes", 1)}


def ptxas_report(log: str, kernels: dict) -> dict:
    """Registers, spills and static shared memory of each named kernel,
    from the ``-Xptxas -v`` lines of the build log, with the dynamic shared
    memory its launcher asks for (flash: ``flash_attention_smem_bytes``;
    the staged shuffle: ``staged_smem_bytes`` of the HIGGS tile; the scans'
    backwards: ``SCAN_BWD_SMEM``)."""
    import re

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.rsp_shuffle import staged_smem_bytes

    lines = log.splitlines()
    out = {}
    for name, mangled in kernels.items():
        info = {}
        for i, line in enumerate(lines):
            if "Function properties for" in line and mangled in line:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines[i + 1])
                if m:
                    info["spill_stores"], info["spill_loads"] = int(m[1]), int(m[2])
                for nxt in lines[i + 1:i + 4]:
                    if "Used" in nxt:
                        r = re.search(r"Used (\d+) registers", nxt)
                        sm = re.search(r"(\d+) bytes smem", nxt)
                        info["registers"] = int(r[1]) if r else None
                        info["static_smem"] = int(sm[1]) if sm else 0
                        break
        check("registers" in info, f"the build log has no ptxas report of {name}")
        if name.startswith("fa_wgmma_bf16"):
            d = int(name.split("<")[1].rstrip(">"))
            info["dynamic_smem"] = _cuda.library().flash_attention_smem_bytes(d)
        elif name.startswith("fa_bwd_"):
            d = int(name.split("<")[1].rstrip(">"))
            info["dynamic_smem"] = _cuda.library().flash_attention_bwd_smem_bytes(
                d, 0 if "dkdv" in name else 1)
        elif name == "rsp_shuffle_staged<u32, 1024>":
            info["dynamic_smem_higgs_tile"] = staged_smem_bytes(1100, 29 * 4)
        elif name in SCAN_BWD_SMEM:
            fn, which = SCAN_BWD_SMEM[name]
            info["dynamic_smem"] = getattr(_cuda.library(), fn)(which)
        out[name] = info
    return out


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--records", type=int, default=11_000_000)
    ap.add_argument("--out", default=None, help="directory for the build log and JSON")
    ap.add_argument("--ingest-child", nargs=3, metavar=("NPY", "STORE", "DEVICE"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", nargs=2, metavar=("STORE", "DEVICE"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--partition-child", nargs=2, metavar=("NPY", "DEVICE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ingest_child or args.mesh_child or args.partition_child:
        sys.path.insert(0, str(SRC))
        if args.ingest_child:
            got = ingest_child(*args.ingest_child[:2], args.seed, args.ingest_child[2])
        elif args.mesh_child:
            got = mesh_child(*args.mesh_child)
        else:
            got = partition_child(args.partition_child[0], args.seed, args.partition_child[1])
        print(json.dumps(got), flush=True)
        return 0
    if args.records % (BLOCKS * BLOCKS):
        print(f"chip_smoke: --records must be a multiple of {BLOCKS * BLOCKS}", file=sys.stderr)
        return 2

    import os

    # the restart gate runs under torch.use_deterministic_algorithms, which
    # wants cuBLAS's workspace fixed before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # float32 products in full float32 (the plain versions are the yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _cuda

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    gpu = nvidia_smi()
    print(gpu, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _cuda.library()
    phase("build", t0, f"sources hash {_cuda.source_hash()}")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}")
    for name, info in ptxas_report(_cuda.build_log(), {**REDESIGNED, **SCAN_BWD_KERNELS}).items():
        print(f"  kernel {name}: {json.dumps(info)}", flush=True)

    t0 = time.perf_counter()
    errs = parity(args, device)
    phase("parity", t0, json.dumps(errs))
    t0 = time.perf_counter()
    errs["flash_attention"] = flash_parity(args, device)
    phase("flash parity", t0, f"max |kernel - plain| {errs['flash_attention']:.3g}")
    t0 = time.perf_counter()
    errs["flash_attention_bwd"] = flash_bwd_parity(args, device)
    phase("flash bwd parity", t0, f"max |kernel - plain| {errs['flash_attention_bwd']:.3g}")
    t0 = time.perf_counter()
    errs["mamba2_ssd"] = ssd_parity(args, device)
    phase("ssd parity", t0, f"max |kernel - plain| {errs['mamba2_ssd']:.3g}")
    t0 = time.perf_counter()
    errs["rwkv6_wkv"] = wkv_parity(args, device)
    phase("wkv parity", t0, f"max |kernel - plain| {errs['rwkv6_wkv']:.3g}")
    t0 = time.perf_counter()
    scan_bwd = {"mamba2_ssd_bwd": ssd_bwd_parity(args, device)}
    errs["mamba2_ssd_bwd"] = worst_abs(scan_bwd["mamba2_ssd_bwd"])
    phase("ssd bwd parity", t0, f"max |kernel - plain| {errs['mamba2_ssd_bwd']:.3g}, worst"
          f" relative L2 of a summed gradient"
          f" {worst_rel_l2(scan_bwd['mamba2_ssd_bwd'], ('ddA', 'dB', 'dC')):.3g}")
    t0 = time.perf_counter()
    scan_bwd["rwkv6_wkv_bwd"] = wkv_bwd_parity(args, device)
    errs["rwkv6_wkv_bwd"] = worst_abs(scan_bwd["rwkv6_wkv_bwd"])
    phase("wkv bwd parity", t0, f"max |kernel - plain| {errs['rwkv6_wkv_bwd']:.3g}, worst"
          f" relative L2 of a summed gradient"
          f" {worst_rel_l2(scan_bwd['rwkv6_wkv_bwd'], ('dlogw', 'du')):.3g}")

    tune_dir = tempfile.mkdtemp(prefix="rsp_autotune_")
    try:
        t0 = time.perf_counter()
        tuned = autotune_phase(args, device, str(Path(tune_dir) / "autotune_torch.json"), gpu)
        phase("autotune", t0, f"{tuned['measurements']} keys tuned into {tuned['cache']};"
              f" max |candidate - plain| {tuned['max_abs_err']:.3g}")
        measured = tuned["measurements"]

        path = main_path(args, device)
        measured = no_new_tuning(measured, "the main path")
        data = path.pop("data")
        path["e2e"]["torch_backend"] = torch_backend(args, data, device,
                                                     path["e2e"]["partition_s"])
        tmp = tempfile.mkdtemp(prefix="rsp_ingest_")
        child = None
        try:
            child = ingest_start(args, data, tmp, device)
            # the card-bound phases that need no ingested store run while the
            # ingest child, a host process, works
            torch.cuda.empty_cache()
            hy = hybrid_serving(args, device, gpu)
            t0 = time.perf_counter()
            rw = rwkv_serving(args, device, gpu)
            phase("rwkv", t0)
            t0 = time.perf_counter()
            tr = training(args, device, gpu)
            phase("training", t0)
            t0 = time.perf_counter()
            tf = training_families(args, device, gpu)
            phase("training families", t0)
            ing = ingest(args, data, child, device)
            inputs = learning_inputs(data, args.records // BLOCKS)
            del data
            ds = ing.pop("dataset")
            est = estimator(ds)
            learn = learning(args, ds, inputs)
            ds.close()
            del ds
            measured = no_new_tuning(measured, "the ingest, the estimator and the learning phase")
            srv = serving(str(Path(tmp) / "ingested.rsp"), device)
            measured = no_new_tuning(measured, "the serve phase")
            msh = mesh(args, tmp, device)
            measured = no_new_tuning(measured, "the mesh phase (its children report theirs)")
        finally:
            if child is not None and child["proc"].poll() is None:
                child["proc"].kill()
                child["proc"].wait()
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
        path["e2e"].update(ingest=ing["ingest"], estimator=est, learning=learn, serve=srv,
                           mesh=msh, autotune=tuned)
        lm = lm_serving(args, device, gpu)
        t0 = time.perf_counter()
        mo = moe_serving(args, device, gpu)
        phase("moe", t0)

        t0 = time.perf_counter()
        tm = times(args, device)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)

    tm["flash_attention"] = flash_times(args, device)
    print(f"flash_attention times: {json.dumps(tm['flash_attention'])} [{gpu}]", flush=True)
    tm["flash_attention_d112"] = flash_times(args, device, "zamba2-7b shared block")
    print(f"flash_attention times at zamba2-7b's shared block (D = 112):"
          f" {json.dumps(tm['flash_attention_d112'])} [{gpu}]", flush=True)
    tm["flash_attention_d80"] = flash_times(args, device, "hubert-xlarge encoder")
    print(f"flash_attention times at hubert-xlarge's encoder (D = 80):"
          f" {json.dumps(tm['flash_attention_d80'])} [{gpu}]", flush=True)
    tm["flash_attention_bwd"] = flash_bwd_times(args, device, "llama3.2-1b train")
    print(f"flash_attention_bwd times: {json.dumps(tm['flash_attention_bwd'])} [{gpu}]", flush=True)
    tm["flash_attention_bwd_d80"] = flash_bwd_times(args, device, "hubert-xlarge train")
    print(f"flash_attention_bwd times at hubert-xlarge's shape (D = 80):"
          f" {json.dumps(tm['flash_attention_bwd_d80'])} [{gpu}]", flush=True)
    tm["mamba2_ssd"] = ssd_times(args, device)
    print(f"mamba2_ssd times: {json.dumps(tm['mamba2_ssd'])} [{gpu}]", flush=True)
    tm["rwkv6_wkv"] = wkv_times(args, device)
    print(f"rwkv6_wkv times: {json.dumps(tm['rwkv6_wkv'])} [{gpu}]", flush=True)
    tm["mamba2_ssd_bwd"] = ssd_bwd_times(args, device)
    print(f"mamba2_ssd_bwd times: {json.dumps(tm['mamba2_ssd_bwd'])} [{gpu}]", flush=True)
    tm["rwkv6_wkv_bwd"] = wkv_bwd_times(args, device)
    print(f"rwkv6_wkv_bwd times: {json.dumps(tm['rwkv6_wkv_bwd'])} [{gpu}]", flush=True)
    phase("times", t0)

    replaces = {
        "rsp_shuffle": "src/repro/kernels/rsp_shuffle/kernel.py:44",
        "block_sketch": "src/repro/kernels/block_sketch/kernel.py:82",
        "plan_sketch": "src/repro/kernels/plan/kernel.py:129",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:72",
        # the reference's blockwise backward of that kernel's attention (jnp)
        "flash_attention_bwd": "src/repro/models/attention.py:240",
        "mamba2_ssd": "src/repro/kernels/mamba2_ssd/kernel.py:69",
        "rwkv6_wkv": "src/repro/kernels/rwkv6_wkv/kernel.py:76",
        # the scans the reference differentiates with jax.grad in training
        "mamba2_ssd_bwd": "src/repro/models/mamba2.py:78",
        "rwkv6_wkv_bwd": "src/repro/models/rwkv6.py:77",
    }
    launches = {k: path["counts"][k] for k in ("rsp_shuffle", "block_sketch", "plan_sketch")}
    # flash's row: llama3.2-1b's generate; zamba2-7b's is in launches_by_path
    launches["flash_attention"] = lm["counts"]["flash_attention"]
    # the backward's row: llama3.2-1b's 20 training steps on the drift corpus
    launches["flash_attention_bwd"] = tr["llama"]["counts"]["flash_attention_bwd"]
    launches["mamba2_ssd"] = hy["counts"]["mamba2_ssd"]
    # rwkv6_wkv's row: rwkv6-1.6b's stateless forward; the loss and the
    # generate are in launches_by_path
    launches["rwkv6_wkv"] = rw["counts"]["forward"]["rwkv6_wkv"]
    # the scans' backward rows: zamba2-7b's and rwkv6-1.6b's training steps
    launches["mamba2_ssd_bwd"] = tf["zamba2-7b"]["counts"]["mamba2_ssd_bwd"]
    launches["rwkv6_wkv_bwd"] = tf["rwkv6-1.6b"]["counts"]["rwkv6_wkv_bwd"]
    family_runs = {f"{arch} training ({r['steps']} steps)": r["counts"] for arch, r in tf.items()}
    by_path = {
        "rsp_shuffle": {"main path": path["counts"]["rsp_shuffle"],
                        "collective partition": msh["partition"]["launches"]},
        "block_sketch": {"main path": path["counts"]["block_sketch"],
                         "estimator": est["counts"]["block_sketch"],
                         "drift monitor": learn["monitor"]["launches"]["block_sketch"],
                         "serve wave": srv["wave"]["launches"]["block_sketch"],
                         "mesh query": msh["threads"]["launches"]["block_sketch"]},
        "plan_sketch": {"main path": path["counts"]["plan_sketch"],
                        "serve wave": srv["wave"]["launches"]["plan_sketch"],
                        "mesh query": msh["threads"]["launches"]["plan_sketch"]},
        "flash_attention": {"llama3.2-1b generate": lm["counts"]["flash_attention"],
                            "zamba2-7b generate": hy["counts"]["flash_attention"],
                            **{f"{name} generate": m["counts"]["flash_attention"]
                               for name, m in mo.items()},
                            "llama3.2-1b training (20 steps)":
                                tr["llama"]["counts"]["flash_attention"],
                            "llama3.2-1b training, no drift (20 steps)":
                                tr["llama_no_drift"]["counts"]["flash_attention"],
                            "hubert-xlarge training (20 steps)":
                                tr["hubert"]["counts"]["flash_attention"],
                            "hubert-xlarge forward": tr["hubert"]["forward"]["counts"][
                                "flash_attention"],
                            **{run: c["flash_attention"] for run, c in family_runs.items()
                               if c["flash_attention"]}},
        "flash_attention_bwd": {
            "llama3.2-1b training (20 steps)": tr["llama"]["counts"]["flash_attention_bwd"],
            "llama3.2-1b training, no drift (20 steps)":
                tr["llama_no_drift"]["counts"]["flash_attention_bwd"],
            "hubert-xlarge training (20 steps)": tr["hubert"]["counts"]["flash_attention_bwd"],
            **{f"one {tag} step": st["counts"]["flash_attention_bwd"]
               for tag, st in tr["flat_step"].items() if isinstance(st, dict)},
            **{run: c["flash_attention_bwd"] for run, c in family_runs.items()
               if c["flash_attention_bwd"]}},
        "mamba2_ssd": {"zamba2-7b generate": hy["counts"]["mamba2_ssd"],
                       **{run: c["mamba2_ssd"] for run, c in family_runs.items()
                          if c["mamba2_ssd"]}},
        "rwkv6_wkv": {**{f"rwkv6-1.6b {p}": rw["counts"][p]["rwkv6_wkv"]
                         for p in ("forward", "loss", "generate")},
                      **{run: c["rwkv6_wkv"] for run, c in family_runs.items()
                         if c["rwkv6_wkv"]}},
        "mamba2_ssd_bwd": {run: c["mamba2_ssd_bwd"] for run, c in family_runs.items()
                           if c["mamba2_ssd_bwd"]},
        "rwkv6_wkv_bwd": {run: c["rwkv6_wkv_bwd"] for run, c in family_runs.items()
                          if c["rwkv6_wkv_bwd"]},
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": tm[name]["ms"],
            "plain_ms": tm[name]["plain_ms"],
            "bound_ms": tm[name]["bound_ms"],
            "bound_by": tm[name]["bound_by"],
            "library_ms": tm[name]["library_ms"],
            "device_ms": tm[name]["device_ms"]["ms"],
            "device_ms_seen": {k: v for k, v in tm[name]["device_ms"].items() if k != "ms"},
            "shape": tm[name]["shape"],
            **({"launches_by_path": by_path[name]} if name in by_path else {}),
            **{k: tm[name][k] for k in ("kernels_per_call", "x3_bound_ms", "x3_bound_by", "launch",
                                        "tuned_ms", "tuned_config") if k in tm[name]},
        }
        for name in replaces
    ]}
    print(f"end_to_end: {json.dumps(path['e2e'])}", flush=True)
    print(f"serving: {json.dumps({k: v for k, v in lm.items() if k != 'counts'})}", flush=True)
    print(f"hybrid serving: {json.dumps(hy['serve'])}", flush=True)
    print(f"rwkv scoring: {json.dumps(rw['scoring'])}", flush=True)
    print(f"rwkv serving: {json.dumps(rw['serve'])}", flush=True)
    print(f"moe serving: {json.dumps(mo)}", flush=True)
    print(f"training: {json.dumps(tr)}", flush=True)
    print(f"training families: {json.dumps(tf)}", flush=True)
    print(f"scan backward parity: {json.dumps(scan_bwd)}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the imports", flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "build.log").write_text(_cuda.build_log())
        (out / "chip_smoke.json").write_text(json.dumps(
            {"kernels": record["kernels"], "plan_sketch_where": tm["plan_sketch_where"],
             "flash_attention_d112": tm["flash_attention_d112"],
             "flash_attention_d80": tm["flash_attention_d80"],
             "end_to_end": path["e2e"], "serving": lm, "hybrid_serving": hy,
             "rwkv": rw, "moe": mo, "training": tr, "training_families": tf,
             "scan_bwd_parity": scan_bwd,
             "flash_attention_bwd_d80": tm["flash_attention_bwd_d80"], "gpu": gpu},
            indent=1))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
