#!/usr/bin/env python3
"""Time the flash_attention (forward and backward), rsp_shuffle,
mamba2_ssd and rwkv6_wkv (forward and backward), block_sketch and
plan_sketch kernels of one checkout, or of two checkouts in turns on the
same card.

    python3 kernel_times.py                  # this checkout
    python3 kernel_times.py --against DIR    # DIR, this, this, DIR
    python3 kernel_times.py --only flash_bwd --against DIR   # some groups only

DIR is another checkout of the repository (for example the parent commit
unpacked with ``git archive`` into an ignored directory); each run is a
process of its own that imports the port from that checkout's ``src/``
and builds its kernels into that checkout's ``build/``.  A run times, with
``chip_smoke.py``'s helpers, flash attention in bf16 through
``flash_attention`` at llama3.2-1b's and zamba2-7b's prefill shapes
(causal) and hubert-xlarge's encoder (D = 80, full), in the layer's
strided layout (a checkout without a D = 80 kernel pads it), the
flash backward at ``chip_smoke.py``'s ``BWD_CASES`` (llama3.2-1b's and
hubert-xlarge's training shapes, made by ``bwd_inputs``: each checkout
pads hubert's D = 80 to its own kernel's width), and
the shuffle at the HIGGS partition's [100, 110000, 29] float32, tile 1100,
the SSD scan at zamba2-7b's prefill shape (xbar [8, 2048, 112, 64]) and the
WKV at rwkv6-1.6b's ([8, 2048, 32, 64]), float32, their backward kernels at
the same shapes as ``chip_smoke.py``'s training cases build their inputs
(``ssd_bwd_inputs``, ``wkv_bwd_inputs``; a checkout without them times
none), and the sketches at the
query path's shapes: block_sketch on a [110000, 29] float32 block with 128
bins (query (a)), plan_sketch with query (c)'s plan (group_by c28, G 2) and
query (b)'s (c0 > 0.5, columns 0 and 28), bins 0, over 8 rotating blocks
(twice the L2).  ``ms`` is CUDA events around back-to-back wrapper calls
(for the sketches, what the tree's query path calls),
``device_ms`` the device time of the kernels one call launches (summed; a
checkout names them in its ``KERNELS``, one from before that has the
kernels of the old names) from ``torch.profiler``, and ``others`` the
other device events a call brings (memsets, casts) that ``device_ms``
leaves out; beside one ``scaled_dot_product_attention`` (K/V
head-expanded; for the backward, its backward at the unpadded D) or
``index_select`` call on the same inputs (no PyTorch
call computes the SSD, the WKV or the sketches) and, for the sketches, the
bound.  Each run prints one JSON line; with --against, the last line holds
each checkout's medians and their ratio.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = 20
SHUFFLE_REPS = 5
GROUPS = ("flash", "flash_bwd", "shuffle", "ssd", "wkv", "ssd_bwd", "wkv_bwd", "sketch")
KEYS = ("flash_llama", "flash_zamba2", "flash_hubert", "flash_bwd_llama", "flash_bwd_hubert", "shuffle", "ssd",
        "wkv", "ssd_bwd", "wkv_bwd", "block_sketch", "plan_c", "plan_b")


def one(src: Path, seed: int, groups=GROUPS) -> dict:
    """Time the kernels of ``groups`` of the port under ``src`` (this
    process only)."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device is available")
    device = torch.device("cuda", 0)
    out = {"src": str(src), "gpu": cs.nvidia_smi()}
    timers = {"flash": flash_times, "flash_bwd": flash_bwd_times, "shuffle": shuffle_times,
              "ssd": ssd_times, "wkv": wkv_times, "ssd_bwd": ssd_bwd_times,
              "wkv_bwd": wkv_bwd_times, "sketch": sketch_times}
    for group in groups:
        timers[group](out, cs, device, seed)
        torch.cuda.empty_cache()
    return out


def flash_times(out: dict, cs, device, seed: int) -> None:
    """The forward at llama3.2-1b's and zamba2-7b's prefill shapes and
    hubert-xlarge's encoder (D = 80, full; a checkout whose kernel has no
    D = 80 pads it as its ``impl="auto"`` does) beside
    ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention

    for case, key in (("llama3.2-1b prefill", "flash_llama"),
                      ("zamba2-7b shared block", "flash_zamba2"),
                      ("hubert-xlarge encoder", "flash_hubert")):
        B, H, Hkv, S, D, causal, strided = cs.FLASH_CASES[case]
        q, k, v = cs.flash_inputs(B, H, Hkv, S, D, torch.bfloat16, device, seed, strided)
        ke = k.repeat_interleave(H // Hkv, dim=1).contiguous()
        ve = v.repeat_interleave(H // Hkv, dim=1).contiguous()
        qc = q.contiguous()
        run = lambda i: flash_attention(q, k, v, causal=causal)  # noqa: E731
        out[key] = {
            "ms": cs.time_cuda(run, reps=REPS),
            "device_ms": cs.device_ms(run, REPS, "fa_")["ms"],
            "library_ms": cs.time_cuda(
                lambda i: F.scaled_dot_product_attention(qc, ke, ve, is_causal=causal),
                reps=REPS),
        }
        del q, k, v, ke, ve, qc
        torch.cuda.empty_cache()


def flash_bwd_times(out: dict, cs, device, seed: int) -> None:
    """The backward at each training shape of ``chip_smoke.BWD_CASES``,
    beside the backward of one ``scaled_dot_product_attention`` call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    for case, key in (("llama3.2-1b train", "flash_bwd_llama"),
                      ("hubert-xlarge train", "flash_bwd_hubert")):
        q, k, v, dout, causal, scale = cs.bwd_inputs(case, device, seed)
        out32, (m, l) = fa.flash_attention_stats(q, k, v, causal=causal, scale=scale)
        o, lse = out32.bfloat16(), fa.log_sum_exp(m, l)
        del out32, m, l
        run = lambda i: fa.flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, o, dout, lse, causal=causal, scale=scale)
        H, Hkv, D = q.shape[1], k.shape[1], cs.BWD_CASES[case][4]
        qr = q[..., :D].contiguous().requires_grad_()
        ke = k[..., :D].repeat_interleave(H // Hkv, dim=1).contiguous().requires_grad_()
        ve = v[..., :D].repeat_interleave(H // Hkv, dim=1).contiguous().requires_grad_()
        lib_dout = dout[..., :D].contiguous()
        lib_out = F.scaled_dot_product_attention(qr, ke, ve, is_causal=causal, scale=scale)
        out[key] = {
            "ms": cs.time_cuda(run, reps=REPS),
            "device_ms": cs.device_ms(run, REPS, *fa.BWD_KERNELS)["ms"],
            "library_ms": cs.time_cuda(lambda i: torch.autograd.grad(
                lib_out, (qr, ke, ve), lib_dout, retain_graph=True), reps=REPS),
            "head_dim": q.shape[-1],
        }
        del q, k, v, dout, o, lse, qr, ke, ve, lib_dout, lib_out
        torch.cuda.empty_cache()


def shuffle_times(out: dict, cs, device, seed: int) -> None:
    """The shuffle at the HIGGS partition's shape beside ``index_select``."""
    import torch

    from repro_torch.kernels.rsp_shuffle import (
        flat_gather_index, partition_permutations, rsp_shuffle_cuda)

    P = K = cs.BLOCKS
    R, F_ = 110_000, 29
    delta = R // K
    x = torch.randn((P, R, F_), device=device)
    tp, ip = (torch.from_numpy(a).to(device)
              for a in partition_permutations(seed, P, K, delta))
    flat = flat_gather_index(tp, ip, delta)
    xf = x.reshape(P * R, F_)
    run = lambda i: rsp_shuffle_cuda(x, tp, ip, tile_rows=delta)  # noqa: E731
    out["shuffle"] = {
        "ms": cs.time_cuda(run, reps=SHUFFLE_REPS),
        "device_ms": cs.device_ms(run, SHUFFLE_REPS, "rsp_shuffle")["ms"],
        "library_ms": cs.time_cuda(lambda i: xf.index_select(0, flat), reps=SHUFFLE_REPS),
    }
    del x, tp, ip, flat, xf
    torch.cuda.empty_cache()


def ssd_times(out: dict, cs, device, seed: int) -> None:
    """The SSD at zamba2-7b's prefill shape."""
    from repro_torch.kernels import mamba2_ssd

    B, L, H, decay, _ = cs.SSD_CASES["zamba2-7b prefill"]
    arrays, _ = cs.ssd_inputs(B, L, H, decay, device, seed)
    run = lambda i: mamba2_ssd.ssd_cuda(*arrays)  # noqa: E731
    out["ssd"] = {
        "ms": cs.time_cuda(run, reps=REPS),
        "device_ms": cs.device_ms(run, REPS, *getattr(mamba2_ssd, "KERNELS", ("ssd_fwd",)))["ms"],
        "library_ms": None,
    }


def wkv_times(out: dict, cs, device, seed: int) -> None:
    """The WKV at rwkv6-1.6b's prefill shape."""
    from repro_torch.kernels import rwkv6_wkv

    B, T, H, decay, _ = cs.WKV_CASES["rwkv6-1.6b prefill"]
    (r, k, v, w, u), _ = cs.wkv_inputs(B, T, H, decay, device, seed)
    logw = rwkv6_wkv.log_decay(w)
    run = lambda i: rwkv6_wkv.wkv6_cuda(r, k, v, logw, u)  # noqa: E731
    out["wkv"] = {
        "ms": cs.time_cuda(run, reps=REPS),
        "device_ms": cs.device_ms(run, REPS, *getattr(rwkv6_wkv, "KERNELS", ("wkv6_fwd",)))["ms"],
        "library_ms": None,
    }


def ssd_bwd_times(out: dict, cs, device, seed: int) -> None:
    """The SSD's backward kernels at zamba2-7b's training shape."""
    from repro_torch.kernels import mamba2_ssd

    if not hasattr(mamba2_ssd, "ssd_bwd_cuda"):
        return
    B, L, H, decay = cs.SSD_BWD_CASES["zamba2-7b train"]
    args = cs.ssd_bwd_inputs(B, L, H, decay, device, seed)
    run = lambda i: mamba2_ssd.ssd_bwd_cuda(*args)  # noqa: E731
    out["ssd_bwd"] = {
        "ms": cs.time_cuda(run, reps=REPS),
        "device_ms": cs.device_ms(run, REPS, *mamba2_ssd.BWD_KERNELS)["ms"],
        "library_ms": None,
    }


def wkv_bwd_times(out: dict, cs, device, seed: int) -> None:
    """The WKV's backward kernel at rwkv6-1.6b's training shape."""
    from repro_torch.kernels import rwkv6_wkv

    if not hasattr(rwkv6_wkv, "wkv6_bwd_cuda"):
        return
    B, T, H, decay = cs.WKV_BWD_CASES["rwkv6-1.6b train"]
    args = cs.wkv_bwd_inputs(B, T, H, decay, device, seed)
    run = lambda i: rwkv6_wkv.wkv6_bwd_cuda(*args)  # noqa: E731
    out["wkv_bwd"] = {
        "ms": cs.time_cuda(run, reps=REPS),
        "device_ms": cs.device_ms(run, REPS, *rwkv6_wkv.BWD_KERNELS)["ms"],
        "library_ms": None,
    }


def sketch_times(out: dict, cs, device, seed: int) -> None:
    """block_sketch and the two plans' times, with the bounds of chip_smoke.py."""
    from repro_torch.kernels import block_sketch as bsk
    from repro_torch.kernels import plan as plk
    from repro_torch.kernels.block_sketch import kernel as bsk_kernel
    from repro_torch.kernels.block_sketch.ops import grid_tensors
    from repro_torch.kernels.plan import PlanArrays, QueryPlan
    from repro_torch.kernels.plan import kernel as plk_kernel

    # what each tree's query path calls: the packed launchers, or the parent's
    # wrappers before them
    block_call = getattr(bsk_kernel, "block_sketch_packed", bsk.block_sketch_cuda)
    plan_call = getattr(plk_kernel, "plan_sketch_packed", plk.plan_sketch_cuda)

    n, F = 110_000, 29
    blks = [cs.make_block(n, seed + 3 + i, device) for i in range(8)]
    glo, ghi = cs.grid_of(blks[0])
    lo, invw = grid_tensors(glo, ghi, cs.BINS, device)

    def entry(run, names, nbytes, ops):
        dm = cs.device_ms(run, REPS, *names)
        return {"ms": cs.time_cuda(run, reps=REPS), "device_ms": dm["ms"],
                "others_per_call": dm.get("others", 0) / REPS, "library_ms": None,
                "bound_ms": cs.bound_ms(nbytes, ops)[0]}

    out["block_sketch"] = entry(
        lambda i: block_call(blks[i % 8], lo, invw, bins=cs.BINS),
        getattr(bsk, "KERNELS", ("block_sketch_partial", "sketch_finalize")),
        n * F * 4 + 2 * F * 4 + 5 * F * 4 + F * cs.BINS * 8, 10 * n * F)
    for key, plan in (("plan_c", QueryPlan(group_by=28, num_classes=2)),
                      ("plan_b", QueryPlan(predicates="c0 > 0.5", columns=(0, 28)))):
        arrays = PlanArrays.build(plan, F, device)
        cols = plan.resolve_columns(F)
        touched = {p.column for p in plan.predicates} | set(cols)
        if plan.group_by is not None:
            touched.add(plan.group_by % F)
        fp, g = len(cols), plan.groups
        out[key] = entry(
            lambda i: plan_call(blks[i % 8], arrays, None, None, bins=0),
            getattr(plk, "KERNELS", ("plan_sketch_partial", "sketch_finalize")),
            cs.sector_bytes(n, F, sorted(touched)) + len(plan.predicates) * 12 + fp * 4
            + 5 * g * fp * 4 + 4,
            (len(plan.predicates) + 5 * fp) * n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout, timed before and after this one")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated groups to time, of {','.join(GROUPS)}")
    ap.add_argument("--src", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    groups = tuple(args.only.split(","))
    if not set(groups) <= set(GROUPS):
        print(f"kernel_times: --only takes groups of {GROUPS}", file=sys.stderr)
        return 2
    if args.src is not None:
        print(json.dumps(one(args.src, args.seed, groups)), flush=True)
        return 0
    order = [ROOT]
    if args.against is not None:
        other = args.against.resolve()
        if not (other / "src" / "repro_torch" / "__init__.py").is_file():
            print(f"kernel_times: no port under {other}", file=sys.stderr)
            return 1
        order = [other, ROOT, ROOT, other]
    runs = []
    for tree in order:
        res = subprocess.run([sys.executable, __file__, "--src", str(tree / "src"),
                              "--seed", str(args.seed), "--only", args.only],
                             stdout=subprocess.PIPE, text=True)
        if res.returncode != 0:
            print(f"kernel_times: the run of {tree} failed", file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append((tree, json.loads(line)))
    if args.against is not None:
        summary = {}
        for key in (k for k in KEYS if all(k in r for _, r in runs)):
            for metric in ("ms", "device_ms", "library_ms", "others_per_call"):
                # device_ms is None where the profiler missed a launch
                mine = [r[key].get(metric) for t, r in runs
                        if t == ROOT and r[key].get(metric) is not None]
                theirs = [r[key].get(metric) for t, r in runs
                          if t != ROOT and r[key].get(metric) is not None]
                if mine and theirs:
                    m, o = statistics.median(mine), statistics.median(theirs)
                    summary[f"{key} {metric}"] = {"this": m, "against": o,
                                                  "against / this": o / m if m else None}
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
