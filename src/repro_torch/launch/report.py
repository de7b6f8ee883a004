"""Render the dry-run sweep (``launch/dryrun.py``) into the roofline tables.

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_torch

The reference's tables from the port's results; the fit column holds each
cell against the card's memory (``launch.mesh.HBM_CAPACITY``, the H100's
80 GB) where the reference's holds it against a v5e's 16 GiB.  Every
figure is one rank's traced program on the H100's data-sheet peaks
(``launch/roofline.py``), not a measurement.
"""

from __future__ import annotations

import json
import os
import sys

from repro_torch.configs import ARCHS, SHAPES, cell_applicable, cells
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.roofline import summarize_cell


def load_results(root: str, *, optimized: bool = False) -> dict[tuple[str, str, bool], dict]:
    out = {}
    for name in os.listdir(root):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(root, name)) as f:
            r = json.load(f)
        if bool(r.get("optimized")) != optimized:
            continue
        out[(r.get("arch"), r.get("shape"), bool(r.get("multi_pod")))] = r
    return out


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def dryrun_table(results: dict) -> str:
    fit = f"fits {mesh_lib.HBM_CAPACITY // 10**9}G?"
    lines = [
        f"| arch | shape | mesh | compile | args/chip | temp/chip | {fit} | HLO flops/chip | collective bytes/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape in cells():
        for mp in (False, True):
            r = results.get((arch, shape, mp))
            mesh = "2x16x16" if mp else "16x16"
            if r is None:
                lines.append(f"| {arch} | {shape} | {mesh} | MISSING | | | | | |")
                continue
            mem = r.get("memory", {})
            args = mem.get("argument_size_in_bytes", 0)
            temp = mem.get("temp_size_in_bytes", 0)
            fits = "yes" if (args + temp) < mesh_lib.HBM_CAPACITY else "NO"
            a = r.get("analysis", {})
            coll = sum(v["bytes"] for v in a.get("collectives", {}).values())
            lines.append(
                f"| {arch} | {shape} | {mesh} | {r.get('compile_s', '?')}s "
                f"| {fmt_bytes(args)} | {fmt_bytes(temp)} | {fits} "
                f"| {a.get('flops', 0):.2e} | {fmt_bytes(coll)} |"
            )
    return "\n".join(lines)


def skip_table() -> str:
    lines = ["| arch | shape | reason |", "|---|---|---|"]
    for arch in ARCHS:
        for shape in SHAPES:
            ok, why = cell_applicable(arch, shape)
            if not ok:
                lines.append(f"| {arch} | {shape} | {why} |")
    return "\n".join(lines)


def roofline_table(results: dict) -> str:
    lines = [
        "| arch | shape | T_compute | T_memory | T_collective | dominant | MODEL_FLOPS | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape in cells():
        r = results.get((arch, shape, False))
        if r is None or "analysis" not in r:
            continue
        t = summarize_cell(r, ARCHS[arch], SHAPES[shape])
        lines.append(
            f"| {arch} | {shape} | {fmt_s(t['t_compute_s'])} | {fmt_s(t['t_memory_s'])} "
            f"| {fmt_s(t['t_collective_s'])} | **{t['dominant']}** "
            f"| {t['model_flops_global']:.2e} | {t['useful_ratio']:.2f} "
            f"| {t['roofline_fraction']:.3f} |"
        )
    return "\n".join(lines)


def rsp_partition_rows(results: dict) -> str:
    lines = ["| mesh | shape | compile | flops/chip | bytes/chip | all-to-all bytes/chip |", "|---|---|---|---|---|---|"]
    for (a, s, mp), r in sorted(results.items(), key=lambda kv: kv[0][2]):
        if a != "rsp-partition":
            continue
        an = r.get("analysis", {})
        a2a = an.get("collectives", {}).get("all-to-all", {}).get("bytes", 0)
        lines.append(
            f"| {'2x16x16' if mp else '16x16'} | {s} | {r['compile_s']}s "
            f"| {an.get('flops', 0):.2e} | {fmt_bytes(an.get('bytes', 0))} | {fmt_bytes(a2a)} |"
        )
    return "\n".join(lines)


def worst_cells(results: dict, n: int = 8) -> list[tuple]:
    scored = []
    for arch, shape in cells():
        r = results.get((arch, shape, False))
        if r is None or "analysis" not in r:
            continue
        t = summarize_cell(r, ARCHS[arch], SHAPES[shape])
        scored.append((t["roofline_fraction"], arch, shape, t["dominant"], t))
    scored.sort()
    return scored[:n]


def perf_comparison(base: dict, opt: dict) -> str:
    lines = [
        "| arch | shape | T_mem base | T_mem opt | T_coll base | T_coll opt | frac base | frac opt | speedup |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape in cells():
        b = base.get((arch, shape, False))
        o = opt.get((arch, shape, False))
        if b is None or o is None or "analysis" not in b or "analysis" not in o:
            continue
        tb = summarize_cell(b, ARCHS[arch], SHAPES[shape])
        to = summarize_cell(o, ARCHS[arch], SHAPES[shape])
        speed = tb["step_time_s"] / to["step_time_s"] if to["step_time_s"] else float("nan")
        lines.append(
            f"| {arch} | {shape} | {fmt_s(tb['t_memory_s'])} | {fmt_s(to['t_memory_s'])} "
            f"| {fmt_s(tb['t_collective_s'])} | {fmt_s(to['t_collective_s'])} "
            f"| {tb['roofline_fraction']:.4f} | {to['roofline_fraction']:.4f} "
            f"| **{speed:.1f}x** |"
        )
    return "\n".join(lines)


def main() -> None:
    root = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    results = load_results(root)
    print("## Dry-run table (both meshes)\n")
    print(dryrun_table(results))
    print("\n## Skipped cells\n")
    print(skip_table())
    print("\n## Roofline (single-pod, per chip)\n")
    print(roofline_table(results))
    print("\n## RSP partition collective program\n")
    print(rsp_partition_rows(results))
    print("\n## Worst roofline fractions (hillclimb candidates)\n")
    for frac, arch, shape, dom, _ in worst_cells(results):
        print(f"- {arch} x {shape}: frac={frac:.4f} dominant={dom}")
    opt = load_results(root, optimized=True)
    if opt:
        print("\n## Baseline vs optimized (single-pod)\n")
        print(perf_comparison(results, opt))


if __name__ == "__main__":
    main()
