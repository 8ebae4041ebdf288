#!/usr/bin/env python3
"""Drive the PyTorch port (``langstream_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py

Phases (``--phases`` picks a subset, comma-separated, for a partial run):

1. ``build``   — compiles every CUDA kernel of the port from the sources in
   the checkout (one ``nvcc`` per source, all started together, into
   ``build/kernels/``) and prints the build time, each kernel
   instantiation's ptxas register / spill report (and any wgmma
   serialization warning), the segment kernel's SASS instruction mix
   (HGMMA, UTMALDG, ...) and the decode kernel's (UBLKCP bulk copies,
   SYNCS mbarriers, UCGABAR cluster barriers, ...), and the card's name
   and power limit (the decode library's mix also per cache type, with
   its I2F and F2F: int8 widens by prmt and one FADD, not by conversions).
2. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the main paths' shapes (H 32, Hkv 8, D 128, page 64; prefill S 200
   and 1024 at B 2; paged decode at B 8 with ragged lengths 1..1500 and
   at B 32 with lengths 256, 512, ..., 8192, bf16 and int8 pages; segment
   S 200 at offset 1000, S 1024 at offsets 0 and 5000 (B 2, through a
   [..., :6024] view) and S 2048 at offset 6144, in a T 8192 cache, bf16
   and int8; dense decode at B 8, lengths 1..1500, through a [..., :2048]
   view of a T 8192 cache — int8 also through a [..., :2048] view of the
   engine's 8,193-wide sink-column cache, whose scale rows are not 16-byte
   aligned — and at B 32, lengths 256..8192, through the whole cache, bf16
   and int8): every output element within ``atol +
   rtol * |ref|`` of the plain version (and the same check shown to
   reject planted faults: a zeroed 64-key V tile, a K tile or page
   holding the one before it, a causal frontier or lengths one off, and
   for decode one cluster rank's share of keys dropped, and for int8 a
   64-row tile's K scales taken from another tile), NaN past every decode
   row's length (int8: in the scales) leaving the output
   bit-equal, the max abs error, the kernel's time, the plain
   version's time, the bound of the card, and one library call as a
   yardstick where one computes the same function (SDPA, with an explicit
   mask where the kernel masks); the flash rows also give their TFLOP/s
   and bound share, and the segment rows their grid and the K/V bytes it
   streams from L2. Dense decode is also timed against the
   masked read the JAX package takes there under ``auto`` (the port's
   reference ``attention`` over the bounded view).
3. ``e2e``     — the port's ``ServingEngine`` serving llama-3-8b at full
   width and depth (32 layers, bf16, random weights from ``--seed``) on the
   paged layout: 8 requests of 21..1501 byte tokens, greedy, 64 new tokens
   each, with every kernel count set to 0 just before and read just after.
   Every serving run's decode chunks are CUDA-graph replays (``start()``
   captures one graph per sampling branch): each run fails unless its
   replays equal its decode chunks, and its decode kernel's launches must
   be exactly layers x decode steps (counted per replay); its line
   reports the captures, replays, capture seconds and the graph pool's
   bytes. Then a reference check on the same weights: prefill and paged
   decode logits of the kernel path against the reference attention path.
4. ``int8``    — a shorter end-to-end run over the int8 page pool (the
   int8 paged decode kernel), counts read the same way.
5. ``dense``   — the same engine on the dense layout, max_seq_len 8192 (an
   8 GiB big cache): 8 requests of 21..7001 byte tokens, greedy, 32 new
   tokens each; the 3001- and 7001-token prompts prefill in 2 and 4
   segments of 2048 (the segment kernel), decode runs the dense decode
   kernel. Then a dense reference check: a 3000-token prompt through 2
   ``prefill_segment`` calls and 4 ``decode_step_inplace`` steps, kernel
   path against reference path.
6. ``dense_int8`` — 4 requests (one of 3001 tokens), 16 new tokens, over an
   int8 dense cache (the int8 segment and dense decode kernels).
7. ``paged_long`` — llama-3-8b on the paged layout with max_seq_len 8192:
   the ``dense`` phase's 8 requests, whose 3001- and 7001-token prompts
   prefill in 2 and 4 segments of 2048 straight into their pages (the
   segment kernel over the gathered pages), decode through the paged
   decode kernel; then 4 requests (41..3001 tokens, 16 new) over int8
   pages (the int8 segment kernel). Then a paged reference check (a
   3000-token prompt through 2 ``paged_prefill_segment_inplace`` calls
   and 4 paged decode steps, kernel path against reference path), NaN
   planted past a segment's frontier and in the sink page (the kernel
   path's logits must stay bit-equal), and the page gather's time beside
   the segment kernel's for the 2048-token segment at offset 6144.
8. ``graphs``  — the captured decode chunk at full width: for paged bf16,
   paged int8 (max_seq_len 2048) and dense bf16 (8192 wide), 7 requests
   admitted by hand, one chunk, an 8th admitted, then one replay against
   a direct call of the same chunk function on a copy of the same state —
   tokens equal and the pool or cache bit-equal afterwards; on the paged
   layout a replay whose dispatch table was not refreshed after that
   admission must differ (the planted fault). Then two lifecycle drills
   on the card: ``decode@3`` on a one-slot engine (the request in flight
   fails, the engine restarts and captures its graphs again, the queued
   request is token-exact against a fault-free engine) and ``nan@3`` on a
   two-slot engine (one slot quarantined, its pages read back as zeros,
   the survivor token-exact against a fault-free run).
9. ``moe``     — mixtral-8x7b at full width and depth (32 layers, 8
   experts, top-2) with int8 weights drawn on the card (46.9 GB; the
   llama weights are dropped first), paged bf16 KV, max_seq_len 4096: 9
   requests of 21..3001 tokens, 32 new each (the 3001-token prompt takes 2
   paged segments through ``moe_ffn``); tokens/s, TTFT, peak memory (under
   80 GB) and the mean decode step. Then the kernel path against the
   reference path (a 200-token prompt, 4 paged decode steps) and one
   layer's ``moe_ffn`` timed at decode (8 tokens) and at a 2048-token
   segment beside its weight-byte bound.
10. ``profile`` — (not run by default) three short llama-3-8b bursts, bf16
   and int8 page pools and the bf16 dense cache (8192 wide), traced with
   torch.profiler: the device's busy share of the wall and the top
   kernels (no split-K decode kernel may appear).

``--ab PARENT`` runs none of these: it compares the kernel times of another
checkout (say the parent commit, unpacked with ``git archive <commit> | tar
-x -C build/parent``) with this one's, running ``--phases build,kernels``
from each in the order parent, change, change, parent.

Every check raises on failure, so any failure exits non-zero. On success
the last three lines are the ``{"kernels": [...]}`` record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``;
a run that left out a default phase ends with ``{"partial": true, ...}``
instead, and never says ok.
Without a CUDA card, or outside a checkout of the repository, it exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import random
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "e2e", "int8", "dense", "dense_int8", "paged_long", "graphs",
          "moe", "profile")
DEFAULT_PHASES = PHASES[:9]

# H100 SXM published peaks (dense), the denominators of every bound below
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version on the card: every element must satisfy
# |out - ref| <= atol + rtol * |ref|. bf16 outputs round at 2^-8 relative;
# the flash kernels also round p to bf16 against the RUNNING max where the
# plain version uses the row's final max, while the decode kernels keep p
# in f32. Each check must also reject planted faults — the plain version
# with one 64-key V tile zeroed, or with the causal frontier or the
# lengths one off — or the run fails: the 8k-token segment's outputs
# average ~7000 keys (rms ~0.02), so a tolerance of that size sees nothing.
FLASH_TOL = {"atol": 3e-3, "rtol": 2e-2}
DECODE_TOL = {"atol": 1e-3, "rtol": 2e-2}
# kernel path vs reference attention path, end-to-end logits at 32 layers
# in bf16: relative to the largest reference logit
MODEL_REL_TOL = 5e-2

H, HKV, D, PAGE = 32, 8, 128, 64
DECODE_LENGTHS = (1, 64, 200, 511, 700, 1024, 1280, 1500)
# the second decode shape: B = 32 rows of 256, 512, ..., 8192 keys (dense
# through a T = 8192 cache, paged through a pool of exactly their pages
# plus the sink)
DECODE_LENGTHS_LONG = tuple(256 * i for i in range(1, 33))
# dense cases: the cache width, and the decode chunk's readable view of it
DENSE_T, DENSE_VIEW = 8192, 2048
# the batched segment case reads the T = 8192 cache through this view
SEGMENT_VIEW = 6024


def log(msg: str) -> None:
    print(msg, flush=True)


def _excess(out, ref, tol: dict) -> float:
    """max |out - ref| / (atol + rtol |ref|): at most 1 passes."""
    ref = ref.float()
    return ((out.float() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max().item()


def hold(name: str, out, ref, tol: dict, planted: dict | None = None) -> dict:
    """Hold a kernel's output against its plain version's within ``tol``;
    with ``planted`` ({fault: the plain version's output with that fault}),
    also require the same check to reject every planted fault. Returns the
    readings for the record."""
    err = (out.float() - ref.float()).abs().max().item()
    ratio = _excess(out, ref, tol)
    if not math.isfinite(err) or not ratio <= 1.0:
        raise AssertionError(f"{name}: max abs err {err}, {ratio:.3g}x the tolerance {tol}")
    rec = {"max_abs_err": err, "tolerance": tol, "tolerance_used": ratio}
    if planted:
        rec["planted"] = {}
        for fault, wrong in planted.items():
            seen = _excess(wrong, ref, tol)
            rec["planted"][fault] = {
                "max_abs_err": (wrong.float() - ref.float()).abs().max().item(),
                "tolerance_used": seen,
            }
            if not seen > 1.0:
                raise AssertionError(f"{name}: the check cannot see the planted fault {fault} "
                                     f"({seen:.3g}x the tolerance)")
    return rec


def _zero_rows(entry, index):
    """A copy of a cache entry (tensor, or int8 dict) with ``entry[index]``
    zeroed (int8: its values, so the dequantized rows are 0)."""
    if isinstance(entry, dict):
        entry = {n: a.clone() for n, a in entry.items()}
        entry["q"][index] = 0
    else:
        entry = entry.clone()
        entry[index] = 0
    return entry


def _stale_tile(entry, row: int, tile: int, rows: int = 64):
    """A copy of a cache entry (tensor, or int8 dict) whose ``rows``-key
    tile [tile, tile + rows) of batch row ``row`` holds the tile before it —
    what a producer that refilled a ring stage late, or from the wrong
    tile, would leave. (Indexed on the leading dim: a dense row, or a
    page of a pool.)"""
    def stale(a):
        a = a.clone()
        a[row, :, tile:tile + rows] = a[row, :, tile - rows:tile]
        return a
    if isinstance(entry, dict):
        return {n: stale(a) for n, a in entry.items()}
    return stale(entry)


def _stale_scales(entry: dict, row: int, tile: int, rows: int = 64) -> dict:
    """A copy of an int8 cache entry whose ``rows``-key tile [tile, tile +
    rows) of batch row ``row`` keeps its values but holds the K scales of
    the tile before it — what a scale copy from the wrong tile would leave.
    (Indexed on the leading dim: a dense row, or a page of a pool.)"""
    s = entry["s"].clone()
    s[row, :, tile:tile + rows] = s[row, :, tile - rows:tile]
    return {"q": entry["q"], "s": s}


def _flash_rates(rec: dict, flops: float) -> None:
    """The flash rows' rate and their share of the bound, from this run."""
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Per-launch device time with CUDA events, the 50 MB L2 flushed before
    every launch (the main path finds each layer's K/V cold). A spin kernel
    queued ahead of the start event keeps the stream busy while the host
    enqueues the launch, so host-side wrapper time never reads as device
    time."""

    SPIN_CYCLES = 6_000_000  # ~3 ms at the H100's clocks

    def __init__(self, torch) -> None:
        self.torch = torch
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def phase_build(ctx: dict) -> None:
    from langstream_tpu_torch.ops import _build

    t0 = time.monotonic()
    seconds = _build.build_all()
    ctx["build_s"] = time.monotonic() - t0
    log(f"build: {ctx['build_s']:.1f}s total; per source {json.dumps(seconds)}")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Compiling entry" in line:  # which instantiation the next lines report
                    m = re.search(r"(flash_segment|decode_cluster)_kernel(I\w+?E)E", line)
                    line = f"entry {m.group(1)}<{_template_args(m.group(2))}>" if m else line
                elif not re.search(r"registers|spill|error|C75\d\d", line, re.I):
                    continue
                log(f"  ptxas[{name}] {line.strip()[:220]}")
        _build.library(name)  # loads and binds every symbol
    for name, ops in SASS_OPS.items():
        mix = sass_mix(_build.library_path(name), ops)
        log(f"sass[{name}] {json.dumps(mix['all'])}")
        for kind in ("bf16", "int8"):  # the instantiations of each cache type
            log(f"sass[{name} {kind}] {json.dumps(mix[kind])}")
    log(f"card: {smi_line()}")


def _template_args(mangled: str) -> str:
    """'IaLi128ELi4E' → 'int8, 128, 4' (the kernels' template arguments)."""
    names = {"a": "int8", "13__nv_bfloat16": "bf16"}
    return ", ".join(names.get(t, t.strip("LiE"))
                     for t in re.findall(r"Li\d+E|13__nv_bfloat16|a", mangled[1:]))


# the instruction families that show each library's design in its SASS:
# HGMMA (wgmma), UTMALDG (TMA tensor loads), UBLKCP (bulk copies), SYNCS
# (mbarrier operations), UCGABAR (cluster barriers), HMMA (mma.sync, none
# expected), SHFL (warp shuffles), MUFU (ex2 and the rest), I2F and F2F
# (quarter-rate conversions; the decode kernel widens int8 with PRMT and an
# FADD instead)
SASS_OPS = {
    "flash_segment": ("HGMMA", "UTMALDG", "SYNCS", "HMMA", "MUFU"),
    "ragged_decode": ("UBLKCP", "SYNCS", "UCGABAR", "SHFL", "HMMA", "MUFU", "I2F", "F2F",
                      "PRMT"),
}


def sass_mix(lib: Path, families: tuple) -> dict:
    """Counts of the instructions of each family in a library's SASS
    (cuobjdump from the toolkit) → {"all": counts, "bf16": counts of the
    bf16-cache instantiations, "int8": of the int8 ones}. A family is the
    opcode itself, or the opcode and a suffix after "_" (UCGABAR_ARV) — so
    F2F counts no F2FP, I2F no I2FP."""
    from langstream_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts = {key: dict.fromkeys(families, 0) for key in ("all", "bf16", "int8")}
    parts = re.split(r"Function : (\S+)", sass)
    for name, body in zip(parts[1::2], parts[2::2]):
        kind = "int8" if re.search(r"_kernelIa", name) else "bf16"
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body):
            for f in families:
                if op == f or op.startswith(f + "_"):
                    counts["all"][f] += 1
                    counts[kind][f] += 1
    return counts


def _prefill_case(torch, ctx, timer, b: int, s: int) -> dict:
    import torch.nn.functional as F

    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        flash_prefill_attention,
        flash_prefill_reference,
        flash_segment_reference,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + s)
    q = torch.randn((b, s, H, D), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, HKV, s, D), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, HKV, s, D), generator=g, device="cuda").to(torch.bfloat16)
    out = flash_prefill_attention(q, k, v, cfg)
    ref = flash_prefill_reference(q, k, v, cfg)
    tile = (s // 2) // 64 * 64  # a 64-key tile in the middle of the prompt
    planted = {
        "v_tile_zeroed": flash_prefill_reference(
            q, k, _zero_rows(v, (0, 0, slice(tile, tile + 64))), cfg
        ),
        "causal_off_by_one": flash_segment_reference(
            q, k, v, torch.ones(b, dtype=torch.int32, device="cuda"), cfg
        ),
        "k_tile_stale": flash_prefill_reference(q, _stale_tile(k, 0, tile), v, cfg),
    }
    check = hold(f"flash_prefill S={s}", out, ref, FLASH_TOL, planted)
    del planted
    qh = q.transpose(1, 2)
    try:
        F.scaled_dot_product_attention(qh, k, v, is_causal=True, enable_gqa=True)

        def library():
            return F.scaled_dot_product_attention(qh, k, v, is_causal=True, enable_gqa=True)
    except TypeError:  # no enable_gqa: expand K/V once, outside the timing
        ke = k.repeat_interleave(H // HKV, dim=1)
        ve = v.repeat_interleave(H // HKV, dim=1)

        def library():
            return F.scaled_dot_product_attention(qh, ke, ve, is_causal=True)

    flops = 2.0 * b * H * s * (s + 1) * D  # QK^T and PV over the lower triangle
    nbytes = 2 * (2 * b * s * H * D + 2 * b * HKV * s * D)  # q, out, k, v in bf16
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    rec = {
        "shape": f"B={b} S={s} H={H} Hkv={HKV} D={D} bf16",
        **check,
        "ms": timer.ms(lambda: flash_prefill_attention(q, k, v, cfg)),
        "plain_ms": timer.ms(lambda: flash_prefill_reference(q, k, v, cfg), iters=5),
        "library_ms": timer.ms(library),
        "bound_ms": bound,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
    }
    _flash_rates(rec, flops)
    log(f"kernel flash_prefill {json.dumps(rec)}")
    return rec


def _drop_keys(entry, row: int, a: int, b: int):
    """A copy of a dense cache entry (tensor, or int8 dict) whose batch row
    ``row`` lacks keys [a, b): the keys after b move up by b - a (pair it
    with that row's length cut by b - a)."""
    def drop(x):
        x = x.clone()
        x[row, :, a:x.shape[2] - (b - a)] = x[row, :, b:].clone()
        return x
    if isinstance(entry, dict):
        return {n: drop(x) for n, x in entry.items()}
    return drop(entry)


def _pages_dense(entry, table):
    """A pool entry (tensor, or int8 dict) gathered through the table into a
    dense cache [B, Hkv, Tp * page, ...], pages clamped as the kernels do."""
    def gather(a):
        x = a[table.long().clamp(0, a.shape[0] - 1)].transpose(1, 2)  # [B, Hkv, Tp, page, ...]
        return x.reshape(x.shape[0], x.shape[1], -1, *x.shape[4:])
    if isinstance(entry, dict):
        return {n: gather(a) for n, a in entry.items()}
    return gather(entry)


def _rank_share(length: int, plan: dict) -> tuple[int, int]:
    """The keys [a, b) of a row of ``length`` keys that cluster rank 1 of
    the decode kernel reads under ``plan``."""
    from langstream_tpu_torch.ops.attention import decode_rank_tiles

    share = decode_rank_tiles(length, plan, 1)
    tr = plan["tile_rows"]
    return share.start * tr, min(length, share.stop * tr)


def _paged_table(torch, rng, lengths, spare: int):
    """A ragged page table over a shuffled pool of exactly the rows' pages
    plus ``spare`` unmapped ones; unmapped entries carry the sentinel (the
    sink page's index) → (table on the host, number of pages)."""
    need = [math.ceil(n / PAGE) for n in lengths]
    num_pages = sum(need) + spare
    perm = list(range(num_pages))
    rng.shuffle(perm)
    table = torch.full((len(lengths), max(need)), num_pages, dtype=torch.int32)
    cursor = 0
    for row, n in enumerate(need):
        table[row, :n] = torch.tensor(perm[cursor:cursor + n], dtype=torch.int32)
        cursor += n
    return table, num_pages


def _pool_entry(torch, g, shape, int8: bool):
    if int8:
        return {
            "q": torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8),
            "s": torch.rand(shape[:-1], generator=g, device="cuda") * 0.01 + 0.005,
        }
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def _decode_case(torch, ctx, timer, int8: bool, lengths_list: tuple) -> dict:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        decode_launch_plan,
        paged_decode_reference,
        ragged_decode_reference,
        ragged_paged_decode_attention,
        ragged_paged_decode_attention_int8,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    b = len(lengths_list)
    long = b > len(DECODE_LENGTHS)
    rng = random.Random(ctx["seed"] + (1 if int8 else 0) + (100 if long else 0))
    # the short case keeps 16 unmapped pages; the long one a pool of exactly
    # its rows' pages (plus the sink)
    table, num_pages = _paged_table(torch, rng, lengths_list, 0 if long else 16)
    table = table.cuda()
    tp = table.shape[1]
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 7 + (100 if long else 0))
    q = torch.randn((b, H, D), generator=g, device="cuda").to(torch.bfloat16)
    shape = (num_pages + 1, HKV, PAGE, D)  # + the sink page
    k, v = _pool_entry(torch, g, shape, int8), _pool_entry(torch, g, shape, int8)
    kernel = ragged_paged_decode_attention_int8 if int8 else ragged_paged_decode_attention
    out = kernel(q, k, v, lengths, table, cfg, PAGE)
    ref = paged_decode_reference(q, k, v, lengths, table, cfg, PAGE)
    name = "paged_decode_int8" if int8 else "paged_decode"
    # faults in the row of 1024 keys, whose every tile weighs in its output
    row = lengths_list.index(1024)
    n_row = math.ceil(1024 / PAGE)
    mid_page = int(table[row, n_row // 2])
    kq = k["q"] if int8 else k
    plan = decode_launch_plan(q.shape, kq.shape, kq.stride(), kq.dtype, "paged", table_width=tp,
                              scale_strides=k["s"].stride() if int8 else None)
    a, z = _rank_share(1024, plan)
    short = lengths.clone()
    short[row] -= z - a

    def stale_page(entry):
        def stale(x):
            x = x.clone()
            x[mid_page] = x[int(table[row, n_row // 2 - 1])]
            return x
        return {n: stale(x) for n, x in entry.items()} if isinstance(entry, dict) else stale(entry)

    planted = {
        "v_page_zeroed": paged_decode_reference(
            q, k, _zero_rows(v, mid_page), lengths, table, cfg, PAGE
        ),
        "lengths_one_short": paged_decode_reference(
            q, k, v, (lengths - 1).clamp_min(0), table, cfg, PAGE
        ),
        "k_tile_stale": paged_decode_reference(q, stale_page(k), v, lengths, table, cfg, PAGE),
        "split_dropped": ragged_decode_reference(
            q, _drop_keys(_pages_dense(k, table), row, a, z),
            _drop_keys(_pages_dense(v, table), row, a, z), short, cfg,
        ),
    }
    if int8:
        # the mid page's K scales from the page before it (one 64-row tile)
        stale = k["s"].clone()
        stale[mid_page] = stale[int(table[row, n_row // 2 - 1])]
        planted["scale_tile_stale"] = paged_decode_reference(
            q, {"q": k["q"], "s": stale}, v, lengths, table, cfg, PAGE
        )
    check = hold(f"{name} B={b}", out, ref, DECODE_TOL, planted)
    del planted
    tokens = sum(lengths_list)
    item = 1 if int8 else 2
    nbytes = (
        tokens * HKV * D * 2 * item  # K and V rows inside each length
        + (tokens * HKV * 2 * 4 if int8 else 0)  # their f32 scales
        + 2 * b * H * D * 2  # q in, out
        + b * 4 + sum(math.ceil(n / PAGE) for n in lengths_list) * 4  # lengths, table entries
    )
    flops = 4.0 * tokens * H * D  # q.k and p.v per (token, query head)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3
    lens = (f"lengths={list(lengths_list)}" if not long
            else f"lengths=256..{lengths_list[-1]} step 256")
    rec = {
        "shape": f"B={b} {lens} H={H} Hkv={HKV} D={D} page={PAGE} "
                 + ("int8 pages, bf16 q" if int8 else "bf16"),
        **check,
        "ms": timer.ms(lambda: kernel(q, k, v, lengths, table, cfg, PAGE)),
        "plain_ms": timer.ms(
            lambda: paged_decode_reference(q, k, v, lengths, table, cfg, PAGE), iters=5
        ),
        "library_ms": None,  # no single PyTorch call reads a paged pool
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_F32_FLOPS else "operations",
    }
    rec["gbps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["plan"] = {key: plan[key] for key in ("cluster", "tile_rows", "stages", "smem_bytes")}
    log(f"kernel {name} {json.dumps(rec)}")
    return rec


def _sdpa(torch, q, k, v, mask):
    """One scaled_dot_product_attention call over q [B, H, S, D] and GQA
    k/v [B, Hkv, T, D] with a boolean mask (True = attend); K/V are
    expanded to H heads once, outside the timed call, where this PyTorch
    has no enable_gqa."""
    import torch.nn.functional as F

    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:
        ke = k.repeat_interleave(H // HKV, dim=1)
        ve = v.repeat_interleave(H // HKV, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)


def _dense_cache(torch, g, b: int, t: int, int8: bool, hkv: int = HKV, d: int = D):
    shape = (b, hkv, t, d)
    if int8:
        return {
            "q": torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8),
            "s": torch.rand(shape[:-1], generator=g, device="cuda") * 0.01 + 0.005,
        }
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def _bf16(torch, entry):
    """The bf16 cache the int8 segment kernel computes with (dequantized
    as it does), for the library yardstick."""
    if isinstance(entry, dict):
        return (entry["q"].float() * entry["s"][..., None]).to(torch.bfloat16)
    return entry


def kv_stream_bytes(s: int, offsets, t: int, item: int, positions_per_item: int) -> float:
    """Bytes of K and V (and int8 scales) that a segment launch streams from
    L2 into shared memory, computed from its work items: every item of
    ``positions_per_item`` query positions of one kv head reads the keys up
    to its causal frontier min(T, offset + item end), once for its whole
    group of heads."""
    row = HKV * D * 2 * item + (HKV * 2 * 4 if item == 1 else 0)  # K, V (and scales) of a key
    keys = sum(min(t, off + min(s, q0 + positions_per_item))
               for off in offsets for q0 in range(0, s, positions_per_item))
    return float(keys * row)


def _segment_case(torch, ctx, timer, int8: bool, s: int, offsets: tuple,
                  view: int | None = None) -> dict:
    """The segment kernel against its plain version: rows of S queries at
    ``offsets`` in a T = 8192 cache (read through a [..., :view] view where
    given), planted faults in the last row's mid-prefix, times, bound."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        flash_segment_attention,
        flash_segment_attention_int8,
        flash_segment_int8_reference,
        flash_segment_reference,
        segment_launch_plan,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    b = len(offsets)
    seed = ctx["seed"] + 11 + s + int8 + (100 * b if b > 1 else 0)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, H, D), generator=g, device="cuda").to(torch.bfloat16)
    k = _dense_cache(torch, g, b, DENSE_T, int8)
    v = _dense_cache(torch, g, b, DENSE_T, int8)
    t = view or DENSE_T
    if view:
        k, v = ({n: a[:, :, :view] for n, a in e.items()} if int8 else e[:, :, :view]
                for e in (k, v))
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kernel = flash_segment_attention_int8 if int8 else flash_segment_attention
    plain = flash_segment_int8_reference if int8 else flash_segment_reference
    out = kernel(q, k, v, off, cfg)
    ref = plain(q, k, v, off, cfg)
    name = "flash_segment_int8" if int8 else "flash_segment"
    last = b - 1
    tile = (offsets[last] // 2) // 64 * 64  # a 64-key tile in the middle of the last row's prefix
    planted = {
        "v_tile_zeroed": plain(q, k, _zero_rows(v, (last, 0, slice(tile, tile + 64))), off, cfg),
        "causal_off_by_one": plain(q, k, v, off + 1, cfg),
        "k_tile_stale": plain(q, _stale_tile(k, last, tile), v, off, cfg),
    }
    where = f"S={s} offset={offsets[0]}" if b == 1 else f"B={b} S={s} offsets={list(offsets)}"
    check = hold(f"{name} {where}", out, ref, FLASH_TOL, planted)
    del planted
    pos = off.long()[:, None] + torch.arange(s, device="cuda")[None, :]  # [B, S]
    mask = torch.arange(t, device="cuda")[None, None, :] <= pos[:, :, None]  # [B, S, T]
    library = _sdpa(torch, q.transpose(1, 2), _bf16(torch, k), _bf16(torch, v),
                    mask[0] if b == 1 else mask[:, None])
    # work this input needs: query i of row r sees keys [0, offset_r + i];
    # the cache rows below offset_r + S are read once, q read and out
    # written once
    pairs = sum(min(o + i + 1, t) for o in offsets for i in range(s))
    flops = 4.0 * H * D * pairs
    rows = sum(min(o + s, t) for o in offsets)
    item = 1 if int8 else 2
    nbytes = (2 * 2 * b * s * H * D + rows * HKV * D * 2 * item
              + (rows * HKV * 2 * 4 if int8 else 0) + 4 * b)
    plan = segment_launch_plan(q.shape, (b, HKV, t, D), (k["q"] if int8 else k).stride(),
                               torch.int8 if int8 else torch.bfloat16,
                               scale_strides=k["s"].stride() if int8 else None)
    shape = (f"B=1 S={s} offset={offsets[0]} T={DENSE_T}" if b == 1 else
             f"B={b} S={s} offsets={list(offsets)} view T={t} of {DENSE_T}")
    rec = {
        "shape": f"{shape} H={H} Hkv={HKV} D={D} "
                 + ("int8 cache, bf16 q; SDPA over the dequantized cache" if int8 else "bf16"),
        **check,
        "ms": timer.ms(lambda: kernel(q, k, v, off, cfg)),
        "plain_ms": timer.ms(lambda: plain(q, k, v, off, cfg), iters=5),
        "library_ms": timer.ms(library),
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": (
            "operations" if flops / PEAK_BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        ),
        "grid": plan["grid"],
        "work_items": plan["work_items"],
        "l2_kv_gb": kv_stream_bytes(s, offsets, t, item, plan["positions_per_item"]) / 1e9,
    }
    _flash_rates(rec, flops)
    rec["l2_kv_tb_per_s"] = rec["l2_kv_gb"] / rec["ms"]  # GB per ms is TB/s
    log(f"kernel {name} {json.dumps(rec)}")
    return rec


def _dense_decode_case(torch, ctx, timer, int8: bool, lengths_list: tuple, view: int,
                       width: int = DENSE_T) -> dict:
    """Dense decode against its plain version: rows of ``lengths_list`` keys
    through a [..., :view] view of a cache ``width`` columns wide (8192, or
    the engine's 8193 with its sink column; view == width: the whole
    cache), planted faults in the row of 1024 keys, times, bound."""
    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        decode_launch_plan,
        ragged_decode_attention,
        ragged_decode_attention_int8,
        ragged_decode_reference,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    b = len(lengths_list)
    long = b > len(DECODE_LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 21 + int8 + (100 if long else 0))
    q = torch.randn((b, H, D), generator=g, device="cuda").to(torch.bfloat16)

    def cut(entry):
        if isinstance(entry, dict):
            return {n: a[:, :, :view] for n, a in entry.items()}
        return entry[:, :, :view]

    k = cut(_dense_cache(torch, g, b, width, int8))
    v = cut(_dense_cache(torch, g, b, width, int8))
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    kernel = ragged_decode_attention_int8 if int8 else ragged_decode_attention
    out = kernel(q, k, v, lengths, cfg)
    ref = ragged_decode_reference(q, k, v, lengths, cfg)
    name = "dense_decode_int8" if int8 else "dense_decode"
    # faults in the row of 1024 keys, whose every tile weighs in its output
    row = lengths_list.index(1024)
    tile = 512  # a mid-row tile of that row
    kq = k["q"] if int8 else k
    plan = decode_launch_plan(q.shape, kq.shape, kq.stride(), kq.dtype, "dense",
                              scale_strides=k["s"].stride() if int8 else None)
    a, z = _rank_share(1024, plan)
    short = lengths.clone()
    short[row] -= z - a
    planted = {
        "v_tile_zeroed": ragged_decode_reference(
            q, k, _zero_rows(v, (row, slice(None), slice(tile, tile + 64))), lengths, cfg
        ),
        "lengths_one_short": ragged_decode_reference(
            q, k, v, (lengths - 1).clamp_min(0), cfg
        ),
        "k_tile_stale": ragged_decode_reference(
            q, _stale_tile(k, row, tile, plan["tile_rows"]), v, lengths, cfg
        ),
        "split_dropped": ragged_decode_reference(
            q, _drop_keys(k, row, a, z), _drop_keys(v, row, a, z), short, cfg
        ),
    }
    if int8:
        planted["scale_tile_stale"] = ragged_decode_reference(
            q, _stale_scales(k, row, tile, plan["tile_rows"]), v, lengths, cfg
        )
    check = hold(f"{name} B={b}", out, ref, DECODE_TOL, planted)
    del planted
    mask = torch.arange(view, device="cuda")[None, :] < lengths.long()[:, None]  # [B, T]
    library = _sdpa(
        torch, q[:, :, None], _bf16(torch, k), _bf16(torch, v), mask[:, None, None, :]
    )
    tokens = sum(min(n, view) for n in lengths_list)
    item = 1 if int8 else 2
    nbytes = (
        tokens * HKV * D * 2 * item  # K and V rows inside each length
        + (tokens * HKV * 2 * 4 if int8 else 0)  # their f32 scales
        + 2 * b * H * D * 2  # q in, out
        + b * 4  # lengths
    )
    flops = 4.0 * tokens * H * D  # q.k and p.v per (token, query head)
    lens = (f"lengths={list(lengths_list)}" if not long
            else f"lengths=256..{lengths_list[-1]} step 256")
    where = f"view T={view} of {width}" if view < width else f"T={width}"
    rec = {
        "shape": f"B={b} {lens} {where} H={H} Hkv={HKV} D={D} "
                 + ("int8 cache, bf16 q" if int8 else "bf16"),
        **check,
        "ms": timer.ms(lambda: kernel(q, k, v, lengths, cfg)),
        "plain_ms": timer.ms(lambda: ragged_decode_reference(q, k, v, lengths, cfg), iters=5),
        "library_ms": timer.ms(library),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_F32_FLOPS else "operations",
    }
    if not long:
        # the masked read the JAX package takes under "auto" (reference
        # attention over the bounded view, int8 through its hoisted-scale path)
        masked_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8" if int8 else "model")
        rec["masked_path_ms"] = timer.ms(
            lambda: tf.attention(q[:, None], k, v, mask[:, None, :], masked_cfg), iters=5
        )
    rec["gbps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["plan"] = {key: plan[key] for key in ("cluster", "tile_rows", "stages", "smem_bytes")}
    log(f"kernel {name} {json.dumps(rec)}")
    return rec


def _nan_past_length(torch, ctx) -> dict:
    """NaN written where no row may read — past each row's length inside its
    last page or tile and beyond it, and in every unmapped page (the sink
    included) — must leave each decode kernel's output bit-equal to the
    clean run: rows past a row's valid ones never reach the sums, not even
    as 0 * NaN. (The card's twin of tests/test_torch_ops.py::
    test_paged_decode_ignores_pages_past_the_length; int8 caches take the
    NaN in their scales.)"""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        ragged_decode_attention,
        ragged_decode_attention_int8,
        ragged_paged_decode_attention,
        ragged_paged_decode_attention_int8,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    b = len(DECODE_LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 41)
    q = torch.randn((b, H, D), generator=g, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    nan = float("nan")

    def values(entry):  # where the NaN goes: bf16 values, or int8 scales
        return entry["s"] if isinstance(entry, dict) else entry

    def clone(entry):
        return {n: a.clone() for n, a in entry.items()} if isinstance(entry, dict) else entry.clone()

    seen = {}
    for int8 in (False, True):
        table, num_pages = _paged_table(torch, random.Random(ctx["seed"] + 43), DECODE_LENGTHS, 16)
        shape = (num_pages + 1, HKV, PAGE, D)
        k, v = _pool_entry(torch, g, shape, int8), _pool_entry(torch, g, shape, int8)
        paged = ragged_paged_decode_attention_int8 if int8 else ragged_paged_decode_attention
        clean = paged(q, k, v, lengths, table.cuda(), cfg, PAGE)
        mapped = {int(p) for p in table.flatten() if int(p) < num_pages}
        unmapped = [p for p in range(num_pages + 1) if p not in mapped]
        dirty = []
        for entry in (k, v):
            entry = clone(entry)
            for row, n in enumerate(DECODE_LENGTHS):
                if n % PAGE:
                    values(entry)[int(table[row, (n - 1) // PAGE]), :, n % PAGE:] = nan
            values(entry)[unmapped] = nan
            dirty.append(entry)
        out = paged(q, *dirty, lengths, table.cuda(), cfg, PAGE)
        seen[paged.__name__] = bool(torch.equal(clean, out))
        del k, v, dirty
        # the engine's sink-column width: int8 scale rows off the 16-byte grid
        big_k = _dense_cache(torch, g, b, DENSE_T + 1, int8)
        big_v = _dense_cache(torch, g, b, DENSE_T + 1, int8)

        def cut(entry):
            if isinstance(entry, dict):
                return {n: a[:, :, :DENSE_VIEW] for n, a in entry.items()}
            return entry[:, :, :DENSE_VIEW]

        dense = ragged_decode_attention_int8 if int8 else ragged_decode_attention
        clean = dense(q, cut(big_k), cut(big_v), lengths, cfg)
        for entry in (big_k, big_v):
            for row, n in enumerate(DECODE_LENGTHS):
                values(entry)[row, :, n:] = nan  # inside the view and beyond it
        out = dense(q, cut(big_k), cut(big_v), lengths, cfg)
        seen[dense.__name__] = bool(torch.equal(clean, out))
        del big_k, big_v
    bad = [n for n, ok in seen.items() if not ok]
    if bad:
        raise AssertionError(f"NaN past the lengths changed the output of {bad}")
    log(f"kernel nan past the length: bit-equal {json.dumps(seen)}")
    return seen


def _edge_cases(torch, ctx) -> dict:
    """The segment and decode kernels against their plain versions away
    from llama's shape: head dims 64 / 64 / 128 / 256 with groups 1 / 2 / 4
    / 8, a soft cap, per-row offsets 0 and unaligned, a segment whose
    queries run past the cache width, strided [..., :T] views; dense decode
    lengths 0, 1, a tile - 1, a tile, a tile + 1, exactly the view and past
    it; paged decode over pages of 16 (a tile each) and 128 (two tiles of
    64) with lengths 0, 1, page - 1, page, page + 1, the table's width and
    past it, unmapped entries and rows whose cluster ranks have no tiles.
    Each within its tolerance."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        flash_segment_attention,
        flash_segment_attention_int8,
        flash_segment_int8_reference,
        flash_segment_reference,
        paged_decode_reference,
        ragged_decode_attention,
        ragged_decode_attention_int8,
        ragged_decode_reference,
        ragged_paged_decode_attention,
        ragged_paged_decode_attention_int8,
    )

    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 31)
    errs = {}
    for h, hkv, d, cap in ((8, 8, 64, None), (16, 8, 64, None), (32, 8, 128, 30.0),
                           (16, 2, 256, None)):
        cfg = dataclasses.replace(
            MODEL_PRESETS["llama-3-8b"], n_heads=h, n_kv_heads=hkv, head_dim=d,
            attn_logit_softcap=cap,
        )
        for int8 in (False, True):
            # [..., :300] views of 301-column caches
            k = _dense_cache(torch, g, 3, 301, int8, hkv, d)
            v = _dense_cache(torch, g, 3, 301, int8, hkv, d)
            k, v = ({n: a[:, :, :300] for n, a in e.items()} if int8 else e[:, :, :300]
                    for e in (k, v))
            # segment: 77 queries at offsets 0, 37 and 260 (the last row's
            # queries run past the 300-column view)
            q = torch.randn((3, 77, h, d), generator=g, device="cuda").to(torch.bfloat16)
            off = torch.tensor([0, 37, 260], dtype=torch.int32, device="cuda")
            seg = flash_segment_attention_int8 if int8 else flash_segment_attention
            plain = flash_segment_int8_reference if int8 else flash_segment_reference
            name = f"{seg.__name__} H={h} Hkv={hkv} D={d} softcap={cap}"
            errs[name] = hold(name, seg(q, k, v, off, cfg), plain(q, k, v, off, cfg), FLASH_TOL)
            # dense decode over [..., :300] views of 301-column caches
            lengths = torch.tensor([0, 1, 63, 64, 65, 300, 1000], dtype=torch.int32,
                                   device="cuda")
            kd = _dense_cache(torch, g, len(lengths), 301, int8, hkv, d)
            vd = _dense_cache(torch, g, len(lengths), 301, int8, hkv, d)
            kd, vd = ({n: a[:, :, :300] for n, a in e.items()} if int8 else e[:, :, :300]
                      for e in (kd, vd))
            qd = torch.randn((len(lengths), h, d), generator=g, device="cuda").to(torch.bfloat16)
            dec = ragged_decode_attention_int8 if int8 else ragged_decode_attention
            out = dec(qd, kd, vd, lengths, cfg)
            name = f"{dec.__name__} H={h} Hkv={hkv} D={d} softcap={cap}"
            errs[name] = hold(name, out, ragged_decode_reference(qd, kd, vd, lengths, cfg),
                              DECODE_TOL)
            if bool(out[0].abs().max() != 0):
                raise AssertionError(f"{name}: a length-0 row is not 0")
            # paged decode: a table 6 pages wide over a pool of 40 (+ sink)
            paged = ragged_paged_decode_attention_int8 if int8 else ragged_paged_decode_attention
            for ps in (16, 128):
                pk, pv = (_pool_entry(torch, g, (41, hkv, ps, d), int8) for _ in range(2))
                lengths = torch.tensor([0, 1, ps - 1, ps, ps + 1, 6 * ps, 1000],
                                       dtype=torch.int32, device="cuda")
                table = torch.randint(0, 40, (len(lengths), 6), generator=g, device="cuda",
                                      dtype=torch.int32)
                table[0, 1:] = 40  # unmapped: the sentinel (the sink page)
                table[2, 1:] = 40
                out = paged(qd, pk, pv, lengths, table, cfg, ps)
                name = f"{paged.__name__} page={ps} H={h} Hkv={hkv} D={d} softcap={cap}"
                errs[name] = hold(
                    name, out, paged_decode_reference(qd, pk, pv, lengths, table, cfg, ps),
                    DECODE_TOL,
                )
    torch.cuda.synchronize()
    log(f"kernel edge cases {json.dumps(errs)}")
    return errs


def phase_kernels(ctx: dict) -> None:
    import torch

    timer = Timer(torch)
    ctx["kernel_runs"] = {
        "flash_prefill": [_prefill_case(torch, ctx, timer, 2, s) for s in (200, 1024)],
    }
    for int8 in (False, True):
        name = "paged_decode_int8" if int8 else "paged_decode"
        ctx["kernel_runs"][name] = [_decode_case(torch, ctx, timer, int8, lengths)
                                    for lengths in (DECODE_LENGTHS, DECODE_LENGTHS_LONG)]
    for int8 in (False, True):
        name = "flash_segment_int8" if int8 else "flash_segment"
        ctx["kernel_runs"][name] = [
            _segment_case(torch, ctx, timer, int8, s, offs, view)
            for s, offs, view in (((200, (1000,), None), (1024, (0, 5000), SEGMENT_VIEW),
                                   (2048, (6144,), None)))
        ]
        name = "dense_decode_int8" if int8 else "dense_decode"
        # int8 also reads the engine's 8,193-wide cache, whose scale rows
        # are not 16-byte aligned; the widest shape stays last (the record's)
        cases = ((DECODE_LENGTHS, DENSE_VIEW, DENSE_T),)
        if int8:
            cases += ((DECODE_LENGTHS, DENSE_VIEW, DENSE_T + 1),)
        ctx["kernel_runs"][name] = [
            _dense_decode_case(torch, ctx, timer, int8, lengths, view, width)
            for lengths, view, width in cases + ((DECODE_LENGTHS_LONG, DENSE_T, DENSE_T),)
        ]
    _nan_past_length(torch, ctx)
    _edge_cases(torch, ctx)
    del timer


def _prompts(n_bytes: list[int], seed: int) -> list[str]:
    rng = random.Random(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyz     ,.ABCDEFGHIJ0123456789"
    return ["".join(rng.choice(alphabet) for _ in range(n)) for n in n_bytes]


def _serve(ctx, cfg, params, n_bytes: list[int], new_tokens: int, **engine_kw) -> dict:
    """Warm the engine with one short request, zero the kernel counts, serve
    the batch, read the counts; checks every request's tokens, and that no
    kernel's plain version ran."""
    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = ServingEngine(
        cfg, params, max_batch=8, decode_chunk=16, page_size=PAGE,
        eos_token_id=tok.eos_token_id, rng_seed=ctx["seed"], device="cuda", **engine_kw,
    )
    engine.start()
    try:
        engine.generate(tok.encode("warm up"), GenerationOptions(max_new_tokens=4), timeout=600)
        prompts = [tok.encode(p) for p in _prompts(n_bytes, ctx["seed"])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = engine.stats()
        opts = GenerationOptions(max_new_tokens=new_tokens, temperature=0.0)
        reset_kernel_counts()
        t0 = time.monotonic()
        reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in prompts]
        results = [r.result(timeout=900) for r in reqs]
        wall = time.monotonic() - t0
        counts = kernel_counts()
        after = engine.stats()
    finally:
        engine.stop()
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    if plain:
        raise AssertionError(f"plain versions ran on the card's main path: {plain}")
    for p, r in zip(prompts, results):
        if r.error is not None or r.finish_reason not in ("length", "stop"):
            raise AssertionError(f"request of {len(p)} tokens ended {r.finish_reason}: {r.error}")
        if r.finish_reason == "length" and len(r.tokens) != new_tokens:
            raise AssertionError(f"request of {len(p)} tokens gave {len(r.tokens)} tokens")
        if any(t < 0 or t >= cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request of {len(p)} tokens has out-of-range tokens")
    groups = after["admit-groups-total"] - before["admit-groups-total"]
    segments = after["prefill-segments-total"] - before["prefill-segments-total"]
    steps = after["decode-steps-total"] - before["decode-steps-total"]
    chunks = after["decode-chunks-total"] - before["decode-chunks-total"]
    replays = after["graph-replays-total"] - before["graph-replays-total"]
    # every decode chunk of the run is one replay of a graph start() captured
    if chunks <= 0 or replays != chunks or after["graph-captures-total"] != 3:
        raise AssertionError(f"{chunks} decode chunks but {replays} graph replays, "
                             f"{after['graph-captures-total']} captures")
    generated = sum(len(r.tokens) for r in results)
    ttfts = sorted(r.ttft_s for r in results)
    return {
        "requests": len(results),
        "prompt_tokens": [len(p) for p in prompts],
        "generated_tokens": generated,
        "wall_s": wall,
        "tokens_per_s": generated / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "ttft_max_s": ttfts[-1],
        "ttft_longest_prompt_s": max(zip(prompts, results), key=lambda pr: len(pr[0]))[1].ttft_s,
        "admit_groups": groups,
        "segments": segments,
        "decode_steps": steps,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kernel_launches": {k: v["launches"] for k, v in counts.items()},
        "finish_reasons": sorted({r.finish_reason for r in results}),
        "decode_chunks": chunks,
        "graph_replays": replays,
        "graph_captures": after["graph-captures-total"],
        "graph_capture_s": after["graph-capture-s"],
        "graph_pool_bytes": after["graph-pool-bytes"],
    }


def _require_launches(run: dict, kernel: str, per_unit: str, layers: int) -> None:
    """The kernel ran on the run's path: one launch per layer per unit. The
    decode kernels run only inside the captured chunks, whose launches are
    counted per replay: theirs must be exactly layers x decode steps (a
    replay that went uncounted, or a capture counted as launches, fails).
    The prefill and segment kernels are held to the lower bound."""
    got = run["kernel_launches"][kernel]
    want = layers * run[per_unit]
    if "decode" in kernel:
        if got != want or got <= 0:
            raise AssertionError(f"{kernel}: {got} launches != {layers} x {per_unit} "
                                 f"{run[per_unit]}")
    elif got <= 0 or got < want:
        raise AssertionError(f"{kernel}: {got} launches < {layers} x {per_unit} {run[per_unit]}")


def _hold_logits(label: str, logits: dict) -> dict:
    """Kernel-path logits against reference-path logits, step by step:
    finite, within MODEL_REL_TOL of the largest reference logit, and the
    top-1 of each step (recorded)."""
    import torch

    out = {}
    for i, (a, b) in enumerate(zip(logits["kernel"], logits["reference"])):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} step {i}: non-finite kernel-path logits")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        out[f"step{i}_rel_err"] = rel
        out[f"step{i}_top1_equal"] = bool(torch.argmax(a) == torch.argmax(b))
        if rel > MODEL_REL_TOL:
            raise AssertionError(f"{label} step {i}: rel err {rel} > {MODEL_REL_TOL}")
    out["tolerance"] = MODEL_REL_TOL
    return out


def _model_check(ctx, cfg, params) -> dict:
    """Kernel path vs reference attention path on the same weights: prefill
    logits of a 200-token prompt, then 4 paged decode steps over a pool
    filled by that prefill."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    ref_cfg = dataclasses.replace(cfg, attention_impl="jnp")
    prompt = [256] + [(37 * i + 11) % 250 for i in range(199)]
    tokens = torch.tensor([prompt], dtype=torch.long, device="cuda")
    lengths = torch.tensor([len(prompt)], device="cuda")
    s = tokens.shape[1]
    logits = {}
    pools = {}
    table = torch.arange(math.ceil((s + 8) / PAGE), dtype=torch.int32, device="cuda")[None]
    for name, c in (("kernel", cfg), ("reference", ref_cfg)):
        cache = tf.make_kv_cache(c, 1, s, device="cuda")
        lg, cache = tf.prefill(params, tokens, lengths, cache, c)
        pool = tf.make_page_pool(c, table.shape[1], PAGE, device="cuda")
        tf.paged_insert_cache(pool, cache, table, PAGE)
        logits[name] = [lg.float()]
        pools[name] = pool
    # both paths decode the SAME token chain (the reference path's greedy)
    tok = torch.argmax(logits["reference"][0], dim=-1)
    for step in range(4):
        pos = torch.tensor([s + step], device="cuda")
        for name, c in (("kernel", cfg), ("reference", ref_cfg)):
            lg, _ = tf.paged_decode_step_inplace(params, tok, pos, pools[name], table, c, PAGE)
            logits[name].append(lg.float())
        tok = torch.argmax(logits["reference"][-1], dim=-1)
    return _hold_logits(f"model check {cfg.name}", logits)


def _llama_params(ctx):
    import torch

    from langstream_tpu_torch.models.bridge import init_params
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    if "params" not in ctx:
        cfg = MODEL_PRESETS["llama-3-8b"]
        g = torch.Generator(device="cuda").manual_seed(ctx["seed"])
        t0 = time.monotonic()
        ctx["params"] = init_params(cfg, g, device="cuda")
        torch.cuda.synchronize()
        log(f"llama-3-8b random weights on the card in {time.monotonic() - t0:.1f}s "
            f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    return ctx["params"]


def phase_e2e(ctx: dict) -> None:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    run = _serve(ctx, cfg, params, [20, 90, 150, 300, 600, 900, 1200, 1500], 64)
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "paged_decode", "decode_steps", cfg.n_layers)
    log(f"e2e llama-3-8b bf16 {json.dumps(run)}")
    ctx["e2e"] = run
    check = _model_check(ctx, cfg, params)
    log(f"model check llama-3-8b bf16 {json.dumps(check)}")


def phase_int8(ctx: dict) -> None:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = dataclasses.replace(MODEL_PRESETS["llama-3-8b"], kv_cache_dtype="int8")
    params = _llama_params(ctx)
    run = _serve(ctx, cfg, params, [40, 300, 700, 1100], 32)
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "paged_decode_int8", "decode_steps", cfg.n_layers)
    log(f"e2e llama-3-8b int8-kv {json.dumps(run)}")
    ctx["int8"] = run


def _dense_model_check(ctx, cfg, params) -> dict:
    """Kernel path vs reference attention path on the dense layout, same
    weights: a 3000-token prompt through 2 segments of 2048 (the engine's
    kv_bound rule: 2048, then 4096) into a 4096-column local cache, then 4
    decode steps over it."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    ref_cfg = dataclasses.replace(cfg, attention_impl="jnp")
    n, width, cols = 3000, 2048, 4096
    prompt = torch.tensor([[256] + [(37 * i + 11) % 250 for i in range(n - 1)]], device="cuda")
    logits = {}
    caches = {}
    for name, c in (("kernel", cfg), ("reference", ref_cfg)):
        cache = tf.make_kv_cache(c, 1, cols + 1, device="cuda")
        for s0, bound in ((0, width), (width, cols)):
            seg = torch.zeros((1, width), dtype=torch.long, device="cuda")
            real = min(width, n - s0)
            seg[0, :real] = prompt[0, s0 : s0 + real]
            lg, _ = tf.prefill_segment(
                params, seg, torch.tensor([s0], device="cuda"),
                torch.tensor([real], device="cuda"), cache, c, kv_bound=bound,
            )
        logits[name] = [lg.float()]
        caches[name] = cache
    # both paths decode the SAME token chain (the reference path's greedy)
    tok = torch.argmax(logits["reference"][0], dim=-1)
    for step in range(4):
        pos = torch.tensor([n + step], device="cuda")
        for name, c in (("kernel", cfg), ("reference", ref_cfg)):
            lg, _ = tf.decode_step_inplace(params, tok, pos, caches[name], c, kv_bound=cols)
            logits[name].append(lg.float())
        tok = torch.argmax(logits["reference"][-1], dim=-1)
    return _hold_logits("dense model check", logits)


DENSE_KW = {"kv_layout": "dense", "max_seq_len": 8192}


def phase_dense(ctx: dict) -> None:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    run = _serve(ctx, cfg, params, [20, 90, 300, 600, 1200, 1500, 3000, 7000], 32, **DENSE_KW)
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "flash_segment", "segments", cfg.n_layers)
    _require_launches(run, "dense_decode", "decode_steps", cfg.n_layers)
    log(f"dense llama-3-8b bf16 {json.dumps(run)}")
    ctx["dense"] = run
    check = _dense_model_check(ctx, cfg, params)
    log(f"dense model check llama-3-8b bf16 {json.dumps(check)}")


def phase_dense_int8(ctx: dict) -> None:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = dataclasses.replace(MODEL_PRESETS["llama-3-8b"], kv_cache_dtype="int8")
    params = _llama_params(ctx)
    run = _serve(ctx, cfg, params, [40, 300, 1100, 3000], 16, **DENSE_KW)
    _require_launches(run, "flash_segment_int8", "segments", cfg.n_layers)
    _require_launches(run, "dense_decode_int8", "decode_steps", cfg.n_layers)
    log(f"dense llama-3-8b int8-kv {json.dumps(run)}")
    ctx["dense_int8"] = run


PAGED_LONG_KW = {"max_seq_len": 8192}


def _segment_tokens(torch, prompt, s0: int, width: int):
    """One segment of ``prompt`` [1, n] at ``s0``, padded to ``width`` → (tokens
    [1, width], its true length)."""
    seg = torch.zeros((1, width), dtype=torch.long, device="cuda")
    real = min(width, prompt.shape[1] - s0)
    seg[0, :real] = prompt[0, s0:s0 + real]
    return seg, real


def _long_prompt(torch, n: int):
    return torch.tensor([[256] + [(37 * i + 11) % 250 for i in range(n - 1)]], device="cuda")


def _paged_model_check(ctx, cfg, params) -> dict:
    """Kernel path vs reference attention path on the paged layout, same
    weights: a 3000-token prompt through 2 ``paged_prefill_segment_inplace``
    calls of 2048 straight into its 47 pages (the engine's kv_bound rule:
    2048, then 4096), then 4 paged decode steps through the same table."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    ref_cfg = dataclasses.replace(cfg, attention_impl="jnp")
    n, width = 3000, 2048
    prompt = _long_prompt(torch, n)
    table = torch.arange(math.ceil((n + 4) / PAGE), dtype=torch.int32, device="cuda")[None]
    logits, pools = {}, {}
    for name, c in (("kernel", cfg), ("reference", ref_cfg)):
        pool = tf.make_page_pool(c, table.shape[1], PAGE, device="cuda")
        for s0 in (0, width):
            seg, real = _segment_tokens(torch, prompt, s0, width)
            lg, _ = tf.paged_prefill_segment_inplace(
                params, seg, torch.tensor([s0], device="cuda"), torch.tensor([real], device="cuda"),
                pool, table, c, PAGE, kv_bound=s0 + width,
            )
        logits[name] = [lg.float()]
        pools[name] = pool
    # both paths decode the SAME token chain (the reference path's greedy)
    tok = torch.argmax(logits["reference"][0], dim=-1)
    for step in range(4):
        pos = torch.tensor([n + step], device="cuda")
        for name, c in (("kernel", cfg), ("reference", ref_cfg)):
            lg, _ = tf.paged_decode_step_inplace(params, tok, pos, pools[name], table, c, PAGE)
            logits[name].append(lg.float())
        tok = torch.argmax(logits["reference"][-1], dim=-1)
    return _hold_logits("paged model check", logits)


def _paged_nan_check(ctx, cfg, params) -> dict:
    """NaN written into the slot's pages past a segment's frontier — the
    rest of the frontier's page and every later page of its 8192-token
    table — and into the pool's sink page leaves the kernel path's segment
    logits bit-equal: the 2048-token segment at offset 1000 (a mid-page
    frontier, 3048) gathers only its first 48 pages and reads them through
    a [..., :3048] view."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    width, s0 = 2048, 1000
    frontier = s0 + width
    pages = 8192 // PAGE
    table = torch.arange(pages, dtype=torch.int32, device="cuda")[None]
    pool = tf.make_page_pool(cfg, pages, PAGE, device="cuda")
    prompt = _long_prompt(torch, frontier)
    seg, real = _segment_tokens(torch, prompt[:, :s0], 0, width)  # the prefix [0, 1000)
    tf.paged_prefill_segment_inplace(
        params, seg, torch.tensor([0], device="cuda"), torch.tensor([real], device="cuda"),
        pool, table, cfg, PAGE, kv_bound=width,
    )
    seg, real = _segment_tokens(torch, prompt, s0, width)

    def segment():
        return tf.paged_prefill_segment_inplace(
            params, seg, torch.tensor([s0], device="cuda"), torch.tensor([real], device="cuda"),
            pool, table, cfg, PAGE, kv_bound=frontier,
        )[0]

    clean = segment()
    page, row = divmod(frontier, PAGE)
    for name in ("k", "v"):
        pool[name][:, page, :, row:] = float("nan")
        pool[name][:, page + 1:] = float("nan")  # later pages and the sink
    planted = segment()
    same = bool(torch.equal(clean, planted)) and bool(torch.isfinite(clean).all())
    if not same:
        raise AssertionError("NaN past the paged segment's frontier changed its logits")
    return {"frontier": frontier, "pages_gathered": math.ceil(frontier / PAGE),
            "table_pages": pages, "bit_equal": same}


def _gather_cost(torch, ctx, timer) -> dict:
    """The page gather of the 2048-token segment at offset 6144 (one layer,
    128 pages of 64 through a shuffled table, bf16 and int8 pages) beside
    the segment kernel over what it gathered: ms, the gather's byte bound
    and its share of the two; and, as a yardstick, the same gather by
    PyTorch advanced indexing (``pool[pages, heads]``)."""
    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        flash_segment_attention,
        flash_segment_attention_int8,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    s, off = 2048, 6144
    n_pages = (off + s) // PAGE
    rng = random.Random(ctx["seed"] + 51)
    perm = list(range(n_pages))
    rng.shuffle(perm)
    pages = torch.tensor([perm], dtype=torch.long, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 53)
    q = torch.randn((1, s, H, D), generator=g, device="cuda").to(torch.bfloat16)
    offset = torch.tensor([off], dtype=torch.int32, device="cuda")
    out = {}
    for int8 in (False, True):
        shape = (n_pages + 1, HKV, PAGE, D)
        k, v = _pool_entry(torch, g, shape, int8), _pool_entry(torch, g, shape, int8)
        rows = tf._page_rows(pages, HKV)
        kg, vg = tf._gather_pages(k, rows, 1), tf._gather_pages(v, rows, 1)
        hidx = torch.arange(HKV, device="cuda")[None, :, None]
        indexed = {n: a[pages[:, None, :], hidx].flatten(2, 3) for n, a in
                   (k.items() if int8 else (("k", k),))}
        got = kg if int8 else {"k": kg}
        if not all(torch.equal(got[n], indexed[n]) for n in indexed):
            raise AssertionError("the page gather differs from advanced indexing")
        kernel = flash_segment_attention_int8 if int8 else flash_segment_attention
        item = 1 if int8 else 2
        row = HKV * D * item + (HKV * 4 if int8 else 0)  # a token's K (or V) bytes
        nbytes = 2 * 2 * (off + s) * row  # K and V read once, written once

        def by_indexing():
            return [tf._map(lambda a: a[pages[:, None, :], hidx], e) for e in (k, v)]

        rec = {
            "gather_ms": timer.ms(lambda: (tf._gather_pages(k, rows, 1),
                                           tf._gather_pages(v, rows, 1))),
            "gather_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "indexing_ms": timer.ms(by_indexing),
            "segment_ms": timer.ms(lambda: kernel(q, kg, vg, offset, cfg)),
        }
        rec["gather_share"] = rec["gather_ms"] / (rec["gather_ms"] + rec["segment_ms"])
        out["int8" if int8 else "bf16"] = rec
        del k, v, kg, vg
    return out


def phase_paged_long(ctx: dict) -> None:
    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    run = _serve(ctx, cfg, params, [20, 90, 300, 600, 1200, 1500, 3000, 7000], 32, **PAGED_LONG_KW)
    if run["segments"] != 2 + 4:
        raise AssertionError(f"paged_long: {run['segments']} segments, expected 6")
    _require_launches(run, "flash_segment", "segments", cfg.n_layers)
    _require_launches(run, "paged_decode", "decode_steps", cfg.n_layers)
    if run["kernel_launches"]["dense_decode"]:
        raise AssertionError("paged_long: the dense decode kernel ran on the paged layout")
    log(f"paged_long llama-3-8b bf16 {json.dumps(run)}")
    ctx["paged_long"] = run
    int8_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    run8 = _serve(ctx, int8_cfg, params, [40, 300, 1100, 3000], 16, **PAGED_LONG_KW)
    _require_launches(run8, "flash_segment_int8", "segments", cfg.n_layers)
    _require_launches(run8, "paged_decode_int8", "decode_steps", cfg.n_layers)
    log(f"paged_long llama-3-8b int8-kv {json.dumps(run8)}")
    ctx["paged_long_int8"] = run8
    log(f"paged model check llama-3-8b bf16 {json.dumps(_paged_model_check(ctx, cfg, params))}")
    log(f"paged segment nan past the frontier {json.dumps(_paged_nan_check(ctx, cfg, params))}")
    timer = Timer(torch)
    log(f"paged segment gather S=2048 offset=6144 {json.dumps(_gather_cost(torch, ctx, timer))}")
    del timer


# the graphs phase's paged engines: a 2048-token sequence limit keeps the
# pool (and its copies) small; the dense engine is the dense phase's 8192
GRAPHS_KW = {"max_seq_len": 2048}


def _decode_state(engine) -> list:
    """Every tensor a decode chunk reads or writes: the KV pool or cache,
    the chain, the sampling params, the dispatch table and the output."""
    tree = engine._pagepool.dev if engine._paged else engine._cache
    leaves = [leaf for e in tree.values() for leaf in (e.values() if isinstance(e, dict) else (e,))]
    chain = (engine._tokens_dev, engine._positions_dev, engine._temp_dev, engine._top_k_dev,
             engine._top_p_dev, engine._table_dev, engine._chunk_out)
    return leaves + [t for t in chain if t is not None]


def _snapshot(engine) -> tuple:
    memo = engine._table_uploaded
    return [t.clone() for t in _decode_state(engine)], None if memo is None else memo.copy()


def _restore(engine, snap: tuple) -> None:
    tensors, memo = snap
    for dst, src in zip(_decode_state(engine), tensors):
        dst.copy_(src)
    engine._table_uploaded = None if memo is None else memo.copy()


def _differs(engine, snap: tuple) -> dict:
    """Which of the live decode state's tensors differ from a snapshot's
    (bit for bit): {"tokens": the output, "state": anything else}."""
    import torch

    live = _decode_state(engine)
    out_differs = not torch.equal(live[-1], snap[0][-1])
    rest = sum(int(not torch.equal(a, b)) for a, b in zip(live[:-1], snap[0][:-1]))
    return {"tokens": out_differs, "state": rest}


def _hand_admit(engine, prompts, opts) -> None:
    """Admit ``prompts`` through the engine's own admission, driven from
    this thread (the engine thread is not running), first tokens read."""
    from langstream_tpu_torch.serving.engine import GenerationRequest

    for prompt in prompts:
        engine.submit(GenerationRequest(prompt_tokens=prompt, options=opts))
    for entry in engine._admit(10**9):
        engine._process_entry(entry)


def _replay_check(ctx, cfg, params, plant: bool, **engine_kw) -> dict:
    """One captured chunk against a direct call of the same chunk function
    on a copy of the same state, hand-driven at full width: 7 requests
    admitted, one chunk dispatched, an 8th admitted (its slot's table row
    changes), then the chunk replayed and, from the same state, called
    directly — the tokens must be equal and the pool or cache bit-equal.
    With ``plant`` (the paged layout), a replay whose dispatch table was
    not refreshed after that admission must differ, or the check cannot
    see a stale table; and two replays of the sampled branch from one
    state must draw different tokens (the generator advances per
    replay)."""
    import gc

    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = ServingEngine(cfg, params, max_batch=8, decode_chunk=16, page_size=PAGE,
                           rng_seed=ctx["seed"], device="cuda", **engine_kw)
    engine._capture_graphs()
    prompts = [tok.encode(p) for p in _prompts([20, 90, 150, 300, 600, 900, 1200, 1500],
                                               ctx["seed"] + 7)]
    opts = GenerationOptions(max_new_tokens=64)
    rec: dict = {}
    with torch.no_grad():
        _hand_admit(engine, prompts[:7], opts)
        engine._process_entry(engine._dispatch_chunk())
        _hand_admit(engine, prompts[7:], opts)
        branch = engine._branch()
        if plant:
            pre = _snapshot(engine)
            engine._run_chunk(branch)  # the table still masks the 8th slot's row
            stale = _snapshot(engine)
            _restore(engine, pre)
            del pre
        engine._prepare_chunk()
        prepared = _snapshot(engine)
        engine._run_chunk(branch)
        replayed = _snapshot(engine)
        _restore(engine, prepared)
        del prepared
        engine._decode_chunk(*branch)
        torch.cuda.synchronize()
        rec["replay_vs_direct"] = _differs(engine, replayed)
        if plant:
            rec["stale_table_vs_direct"] = _differs(engine, stale)
            del stale
        del replayed
        if plant:
            # the sampled branch twice from one state: the generator is
            # registered with the graph, so the second replay draws anew
            engine._temp_dev.fill_(1.0)
            state = _snapshot(engine)
            engine._run_chunk((True, False))
            first = engine._chunk_out.clone()
            _restore(engine, state)
            del state
            engine._run_chunk((True, False))
            rec["sampled_replays_differ"] = not torch.equal(first, engine._chunk_out)
    stats = engine.stats()
    rec.update({
        "graph_captures": stats["graph-captures-total"],
        "graph_capture_s": stats["graph-capture-s"],
        "graph_pool_bytes": stats["graph-pool-bytes"],
        "active_slots": stats["active-slots"],
    })
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if rec["replay_vs_direct"] != {"tokens": False, "state": 0}:
        raise AssertionError(f"replay differs from the direct call: {rec['replay_vs_direct']}")
    if plant and not (rec["stale_table_vs_direct"]["tokens"]
                      or rec["stale_table_vs_direct"]["state"]):
        raise AssertionError("a replay with a stale dispatch table was not caught")
    if plant and not rec["sampled_replays_differ"]:
        raise AssertionError("two replays of the sampled chunk drew the same numbers")
    return rec


def _first_token(engine, prompt, max_new: int):
    """Submit and wait for the first token (the request is then in a slot)."""
    import threading

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest

    got = threading.Event()
    req = GenerationRequest(prompt_tokens=prompt, options=GenerationOptions(max_new_tokens=max_new),
                            on_token=lambda _t: got.set())
    engine.submit(req)
    if not got.wait(600):
        raise AssertionError("first token never arrived")
    return req


def _decode_fault_drill(ctx, cfg, params) -> dict:
    """``decode@3`` on a one-slot paged engine: the request in flight fails
    with the injected fault, the engine restarts (device state rebuilt,
    the three graphs captured again), and the request queued behind it is
    served token-exact against a fault-free engine."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    p1, p2 = (tok.encode(p) for p in _prompts([300, 120], ctx["seed"] + 9))
    kw = dict(max_batch=1, decode_chunk=16, page_size=PAGE, rng_seed=ctx["seed"],
              device="cuda", **GRAPHS_KW)
    opts = GenerationOptions(max_new_tokens=32)
    ref_engine = ServingEngine(cfg, params, **kw)
    ref_engine.start()
    try:
        ref = ref_engine.generate(p2, opts, timeout=600).tokens
    finally:
        ref_engine.stop()
    engine = ServingEngine(cfg, params, fault_injector=FaultInjector("decode@3", seed=0),
                           restart_backoff_s=0.05, **kw)
    t0 = time.monotonic()
    engine.start()
    try:
        r1 = _first_token(engine, p1, 400)
        r2 = engine.submit(GenerationRequest(prompt_tokens=p2, options=opts))
        try:
            r1.result(timeout=600)
            raise AssertionError("decode@3 did not fail the request in flight")
        except InjectedFault:
            pass
        tokens = r2.result(timeout=600).tokens
        stats = engine.stats()
    finally:
        engine.stop()
    rec = {
        "restarts": stats["engine-restarts-total"],
        "graph_captures": stats["graph-captures-total"],
        "graph_capture_s": stats["graph-capture-s"],
        "quarantined": stats["quarantined-slots-total"],
        "survivor_tokens": len(tokens),
        "survivor_token_exact": tokens == ref,
        "wall_s": time.monotonic() - t0,
    }
    if rec["restarts"] != 1 or rec["graph_captures"] != 6 or not rec["survivor_token_exact"]:
        raise AssertionError(f"decode fault drill: {rec}")
    return rec


def _nan_drill(ctx, cfg, params) -> dict:
    """``nan@3`` on a two-slot paged engine: one slot fails with
    LogitsNaNError, its pages (recorded as the quarantine frees them) read
    back as zeros once the next iteration zeroed them, and the survivor is
    token-exact against the same two requests on a fault-free engine."""
    import torch

    from langstream_tpu_torch.serving.engine import LogitsNaNError, ServingEngine
    from langstream_tpu_torch.serving.faultinject import FaultInjector
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in _prompts([200, 90], ctx["seed"] + 11)]
    kw = dict(max_batch=2, decode_chunk=16, page_size=PAGE, rng_seed=ctx["seed"],
              device="cuda", **GRAPHS_KW)
    outcomes = {}
    for label, injector in (("reference", None), ("fault", FaultInjector("nan@3", seed=0))):
        engine = ServingEngine(cfg, params, fault_injector=injector, **kw)
        freed: dict = {}
        keep = engine._quarantine_pages

        def recording(idx, engine=engine, keep=keep, freed=freed):
            freed[idx] = engine._pagepool.slot_pages(idx)
            keep(idx)

        engine._quarantine_pages = recording
        engine.start()
        try:
            reqs = [_first_token(engine, p, 48) for p in prompts]
            got = []
            for r in reqs:
                try:
                    got.append(r.result(timeout=600).tokens)
                except LogitsNaNError:
                    got.append(None)
            deadline = time.monotonic() + 60
            while engine._pending_page_zero and time.monotonic() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
            leaves = [leaf for e in engine._pagepool.dev.values()
                      for leaf in (e.values() if isinstance(e, dict) else (e,))]
            pages = sorted(p for ps in freed.values() for p in ps)
            zero = bool(pages) and all(
                bool((leaf[:, torch.tensor(pages, device="cuda")] == 0).all()) for leaf in leaves
            )
            stats = engine.stats()
        finally:
            engine.stop()
            del engine._quarantine_pages  # the recorder holds the engine
        outcomes[label] = {"tokens": got, "pages": pages, "zero": zero, "stats": stats}
    ref, fault = outcomes["reference"], outcomes["fault"]
    victims = [i for i, t in enumerate(fault["tokens"]) if t is None]
    rec = {
        "victims": victims,
        "quarantined_pages": len(fault["pages"]),
        "pages_zero": fault["zero"],
        "nan_guard_total": fault["stats"]["nan-guard-total"],
        "survivors_token_exact": all(
            t == r for t, r in zip(fault["tokens"], ref["tokens"]) if t is not None
        ),
        "pages_in_use_after": fault["stats"]["kv-pages-in-use"],
    }
    if (len(victims) != 1 or not rec["pages_zero"] or not rec["survivors_token_exact"]
            or rec["nan_guard_total"] != 1 or rec["pages_in_use_after"] != 0):
        raise AssertionError(f"nan drill: {rec}")
    return rec


def phase_graphs(ctx: dict) -> None:
    """Replay against direct call at full width (paged bf16 and int8 with a
    planted stale table, dense bf16 at 8192), then the lifecycle drills on
    the card (a decode fault's restart and re-capture, a NaN quarantine)."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    int8_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    for label, c, kw, plant in (("paged bf16", cfg, GRAPHS_KW, True),
                                ("paged int8", int8_cfg, GRAPHS_KW, True),
                                ("dense bf16", cfg, DENSE_KW, False)):
        log(f"graphs replay {label} {json.dumps(_replay_check(ctx, c, params, plant, **kw))}")
    log(f"graphs drill decode@3 {json.dumps(_decode_fault_drill(ctx, cfg, params))}")
    log(f"graphs drill nan@3 {json.dumps(_nan_drill(ctx, cfg, params))}")


MOE_KW = {"max_seq_len": 4096}
# a layer's int8 expert weights: gate, up and down of mixtral-8x7b's 8
# experts (1.41 GB), each read once at the least
MOE_EXPERT_BYTES = 3 * 8 * 4096 * 14336


def _decode_step_ms(torch, cfg, params, batch: int = 8, steps: int = 8) -> float:
    """Mean wall of one paged decode step at ``batch`` rows (positions
    300..307, pages of 64) on the stream, host dispatch included."""
    from langstream_tpu_torch.models import transformer as tf

    per_row = math.ceil((300 + batch + steps + 2) / PAGE)
    pool = tf.make_page_pool(cfg, batch * per_row, PAGE, device="cuda")
    table = torch.arange(batch * per_row, dtype=torch.int32, device="cuda").reshape(batch, per_row)
    tokens = torch.zeros(batch, dtype=torch.long, device="cuda")
    pos = 300 + torch.arange(batch, device="cuda")
    for i in range(2):  # warm
        tf.paged_decode_step_inplace(params, tokens, pos + i, pool, table, cfg, PAGE)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        tf.paged_decode_step_inplace(params, tokens, pos + 2 + i, pool, table, cfg, PAGE)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _moe_ffn_times(torch, ctx, cfg, params) -> dict:
    """One layer's ``moe_ffn`` at decode (8 tokens) and at a 2048-token
    segment, each beside the time to read the layer's int8 expert weights
    once at the card's memory rate; the segment also beside its operations
    bound (2 experts a token, three products, at the bf16 peak)."""
    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.models.bridge import torch_dtype

    timer = Timer(torch)
    lp = tf._layer_params(params["layers"], 0)
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 61)
    weight_ms = MOE_EXPERT_BYTES / HBM_BYTES_PER_S * 1e3
    out = {}
    for label, shape in (("decode T=8", (8, 1, cfg.d_model)), ("segment T=2048", (1, 2048, cfg.d_model))):
        x = torch.randn(shape, generator=g, device="cuda").to(torch_dtype(cfg.dtype))
        tokens = shape[0] * shape[1]
        flops = 2.0 * tokens * cfg.n_experts_per_tok * 3 * cfg.d_model * cfg.d_ff
        out[label] = {
            "ms": timer.ms(lambda: tf.moe_ffn(x, lp, cfg), iters=5, warmup=2),
            "weight_bytes_bound_ms": weight_ms,
            "operations_bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "capacity": tf.moe_capacity(tokens, cfg),
        }
    del timer
    return out


def _moe_model_check(ctx, cfg, params) -> dict:
    """``_model_check`` on the MoE model, with each ``moe_ffn`` call's expert
    choice recorded per path (recomputed from its input): the (token,
    layer) pairs whose top-k set differs between the kernel and the
    reference path are counted beside the logits' error — a near-tied
    router choice that flips sends a token through another expert."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    routes = {"auto": [], "jnp": []}
    moe = tf.moe_ffn

    def recording(x, lp, c):
        logits = torch.matmul(x.reshape(-1, x.shape[-1]), lp["router"]).float()
        top = torch.topk(logits, c.n_experts_per_tok, dim=-1).indices
        routes[c.attention_impl].append(top.sort(dim=-1).values)
        return moe(x, lp, c)

    tf.moe_ffn = recording
    try:
        check = _model_check(ctx, cfg, params)
    finally:
        tf.moe_ffn = moe
    pairs = list(zip(routes["auto"], routes["jnp"]))
    check["routing_flips"] = sum(int((a != b).any(dim=-1).sum()) for a, b in pairs)
    check["routed_token_layers"] = sum(a.shape[0] for a, _ in pairs)
    return check


def phase_moe(ctx: dict) -> None:
    import gc

    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.models.quant import init_random_quantized_params

    cfg = MODEL_PRESETS["mixtral-8x7b"]
    ctx.pop("params", None)  # the llama weights: the card holds one model at a time
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2**30
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"])
    t0 = time.monotonic()
    params = init_random_quantized_params(cfg, g, device="cuda")
    torch.cuda.synchronize()
    log(f"mixtral-8x7b random int8 weights on the card in {time.monotonic() - t0:.1f}s "
        f"({before:.2f} GiB allocated before, {torch.cuda.memory_allocated() / 2**30:.2f} after)")
    run = _serve(ctx, cfg, params, [20, 90, 150, 300, 600, 900, 1200, 1500, 3000], 32, **MOE_KW)
    if run["segments"] != 2:
        raise AssertionError(f"moe: {run['segments']} segments, expected 2")
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "flash_segment", "segments", cfg.n_layers)
    _require_launches(run, "paged_decode", "decode_steps", cfg.n_layers)
    if run["peak_memory_gib"] * 2**30 >= 80e9:
        raise AssertionError(f"moe: peak memory {run['peak_memory_gib']:.2f} GiB is not under 80 GB")
    run["decode_step_ms"] = _decode_step_ms(torch, cfg, params)
    log(f"moe mixtral-8x7b int8 weights {json.dumps(run)}")
    ctx["moe"] = run
    log(f"model check mixtral-8x7b int8 weights {json.dumps(_moe_model_check(ctx, cfg, params))}")
    log(f"moe_ffn mixtral-8x7b layer 0 {json.dumps(_moe_ffn_times(torch, ctx, cfg, params))}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _replay_rate(torch, engine, chunks: int = 4) -> dict:
    """Back-to-back replays of the greedy chunk on a burst's engine (its
    slots idle by then): the card's time per decode step, the wall's, and
    the host's time to queue one chunk."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.monotonic()
    start.record()
    for _ in range(chunks):
        engine._run_chunk((False, False))
    end.record()
    host_ms = (time.monotonic() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    steps = chunks * engine.decode_chunk
    return {
        "device_ms_per_step": start.elapsed_time(end) / steps,
        "wall_ms_per_step": wall_ms / steps,
        "host_ms_per_chunk": host_ms / chunks,
    }


def phase_profile(ctx: dict) -> None:
    """Three traced bursts (8 short prompts, 32 new tokens each; bf16 and
    int8 page pools, the bf16 dense cache) under torch.profiler: wall
    time, the summed device time of CUDA kernels, the device's busy share
    of the wall, and the kernels that took the most; then, untraced, the
    time per decode step of back-to-back replays. Every decode launch must
    be the one cluster kernel: a split-K kernel or its merge launch fails
    the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    base = MODEL_PRESETS["llama-3-8b"]
    for label, cfg, kw in (("bf16", base, {}),
                           ("int8-kv", dataclasses.replace(base, kv_cache_dtype="int8"), {}),
                           ("dense-bf16", base, DENSE_KW)):
        engine = ServingEngine(cfg, _llama_params(ctx), max_batch=8, decode_chunk=16,
                               page_size=PAGE, device="cuda", **kw)
        engine.start()
        try:
            prompts = [tok.encode(p) for p in _prompts([100] * 8, ctx["seed"] + 1)]
            opts = GenerationOptions(max_new_tokens=32)
            engine.generate(prompts[0], opts, timeout=600)  # warm
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts))
                        for p in prompts]
                for r in reqs:
                    r.result(timeout=600)
                torch.cuda.synchronize()
                wall_ms = (time.monotonic() - t0) * 1e3
            stats = engine.stats()
        finally:
            engine.stop()
        with torch.no_grad():
            steady = _replay_rate(torch, engine)
        # device activity (kernels, copies, fills) carries self device time;
        # the host-side ops that launched it carry none
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        log(f"profile llama-3-8b {label} decode burst " + json.dumps({
            "wall_ms": wall_ms,
            "device_kernel_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "graph_replays": stats["graph-replays-total"],
            "steady_replays": steady,
            "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
        }))
        stale = [e.key for e in kernels if "decode_split" in e.key or "decode_combine" in e.key]
        if stale:
            raise AssertionError(f"profile {label}: split-K decode kernels launched: {stale}")


def kernel_record(ctx: dict) -> dict:
    # kernel → (source, the TPU kernel it replaces, the phase whose path
    # counts its launches)
    sources = {
        "flash_prefill": ("flash_segment.cu", "langstream_tpu/ops/attention.py:143", "e2e"),
        "paged_decode": ("ragged_decode.cu", "langstream_tpu/ops/attention.py:849", "e2e"),
        "paged_decode_int8": ("ragged_decode.cu", "langstream_tpu/ops/attention.py:979", "int8"),
        "flash_segment": ("flash_segment.cu", "langstream_tpu/ops/attention.py:289", "dense"),
        "flash_segment_int8": (
            "flash_segment.cu", "langstream_tpu/ops/attention.py:383", "dense_int8"
        ),
        "dense_decode": ("ragged_decode.cu", "langstream_tpu/ops/attention.py:526", "dense"),
        "dense_decode_int8": (
            "ragged_decode.cu", "langstream_tpu/ops/attention.py:670", "dense_int8"
        ),
    }
    # every serving run's launches of each kernel (counts zeroed before each)
    served = ("e2e", "int8", "dense", "dense_int8", "paged_long", "paged_long_int8", "moe")
    out = []
    for name, (src, replaces, path) in sources.items():
        runs = ctx.get("kernel_runs", {}).get(name)
        if not runs:
            continue
        main = runs[-1]  # the widest shape measured
        run = ctx.get(path)
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"langstream_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": run["kernel_launches"][name] if run else None,
            "launches_by_phase": {p: ctx[p]["kernel_launches"][name] for p in served if p in ctx},
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            "tolerance": main["tolerance"],
            # the flash rows' rate, and every row's share of its bound, at that shape
            **{key: main[key] for key in ("tflops", "bound_share", "gbps") if key in main},
            # the decode rows at each of their shapes
            **({"by_shape": [
                {key: r[key] for key in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                         "bound_share", "gbps")}
                for r in runs
            ]} if "decode" in name else {}),
        })
    return {"kernels": out}


def ab_times(parent: Path) -> dict[str, list]:
    """Kernel times of another checkout (``parent``) and this one on one
    card: ``chip_smoke.py --phases build,kernels`` run from each, in the
    order parent, change, change, parent → {kernel and shape: [(label,
    ms), ...]}."""
    times: dict[str, list] = {}
    for label, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        run = subprocess.run(
            [sys.executable, "chip_smoke.py", "--phases", "build,kernels"],
            cwd=tree, capture_output=True, text=True, timeout=420,
        )
        if run.returncode != 0:
            raise RuntimeError(f"{label} run in {tree} failed:\n{run.stderr[-3000:]}")
        for line in run.stdout.splitlines():
            m = re.match(r"kernel (\S+) (\{.*\})$", line)
            if m:
                rec = json.loads(m.group(2))
                times.setdefault(f"{m.group(1)} {rec['shape']}", []).append((label, rec["ms"]))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help=f"comma-separated subset of {PHASES} (default: {DEFAULT_PHASES})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", type=Path, metavar="PARENT",
                    help="instead of the phases, compare the kernel times of the checkout "
                         "PARENT with this one's (parent, change, change, parent)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not (ROOT / "langstream_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(langstream_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if args.ab is not None:
        for key, runs in ab_times(args.ab.resolve()).items():
            log(f"ab {key}: " + " ".join(f"{label}={ms:.5f}" for label, ms in runs))
        print(smi_line())
        print(json.dumps({"partial": True, "ab": str(args.ab)}))
        return 0
    ctx: dict = {"seed": args.seed}
    t_all = time.monotonic()
    for phase in PHASES:
        if phase in phases:
            t0 = time.monotonic()
            globals()[f"phase_{phase}"](ctx)
            log(f"phase {phase}: {time.monotonic() - t0:.1f}s")
    log(f"all phases: {time.monotonic() - t_all:.1f}s")
    complete = set(DEFAULT_PHASES) <= set(phases)
    record = kernel_record(ctx)
    if complete:
        for k in record["kernels"]:
            if not k["launches"]:
                raise AssertionError(f"{k['name']} was never launched on its path")
    print(json.dumps(record))
    print(smi_line())
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    # only a run of every default phase may say ok: a partial run checked
    # less, and says so instead
    if complete:
        print(json.dumps({"ok": True, "device": device}))
    else:
        print(json.dumps({"partial": True, "phases": phases, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
