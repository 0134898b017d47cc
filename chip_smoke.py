"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits nonzero; nothing is caught and turned into 0):

1. the card's name and power limit (``nvidia-smi``);
2. build the five CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, started together), print ``-Xptxas -v``'s registers, shared
   memory and spills per instantiation, and fail unless each bf16 flash
   instantiation's SASS (``cuobjdump -sass``) holds ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA loads), and each bf16 decode instantiation's (rows 2
   and 5, bf16/int8/fp8 pools) ``HMMA`` (mma.sync) and ``LDGSTS``
   (cp.async);
3. hold each kernel to its plain PyTorch version on the card, in bf16, at
   the main path's shapes — phase 7's gateway: for each tier at its own
   widths (``smollm-135m``, ``swarm-edge-1b``, ``qwen1.5-110b``,
   ``llama3-8b``), prefill of the 50 study prompts bucketed to S=8, decode
   over the 128-slot cache and the uncertainty terms at the tier's
   vocabulary (row 2 also at the gateway's real fill: index 8-15 of the
   128 slots, the bucket's padding slots at -1), and the safety encoder's
   bidirectional attention — and at
   the shapes of phases 4-5, with a fully masked padding row, duplicate top-k
   logits, tied maxima across a split boundary and likely chosen tokens
   (Eq. 2's term held at a relative tolerance), row 3 also at an odd
   vocabulary (50257), k = 1 and 16 and bf16 logits, every row of 32000
   logits or more split over a cluster; the grid-offset flash attention
   also at S=2048 causal (smollm and llama3 widths), windowed and
   bidirectional, and the positions-mode flash over a warm 320-slot cache
   (phase 4p's continuation spans); time kernel, plain version and, for
   attention, ``scaled_dot_product_attention`` (a yardstick only: the port
   never calls it) with CUDA events, beside each call's least possible time
   and, for attention, its achieved TFLOP/s; then a 2-layer model on the card
   against the port's CPU path, in both uncertainty modes; the block-table
   decode (row 5) at each tier's widths at the paged gateway's decode shape
   (B=50, blocks of 64, 2 per row, 8 delta rows, rows sharing a prefix
   block, a sentinel tail), with int8 and fp8 pools, a ring dispatch longer
   than its window and a 512-slot table, its library time that of SDPA over the
   pre-gathered linear view (same mask, the gather not timed);
4. serve the probe tier: ``smollm-135m`` at full width and depth with
   random weights from ``torch.Generator(seed)`` — ``generate`` on 8 prompts
   of 24-200 tokens, ``serve()`` on the same requests (tie-aware equal to
   ``generate``), ``generate_stepwise`` (tie-aware equal to ``generate``),
   Phase-A ``route`` on the u's with thresholds at their 0.40/0.90
   quantiles; then (4p) the same tier on a paged block pool: ``generate``
   through the block-table kernel and through the gathered view (each
   tie-aware equal to phase 4's), a ~200-token prompt absorbed once and
   fanned out to 16 sessions continued with their own spans (one cold
   prefill; tie-aware equal to cold generates of the concatenations; the
   shared blocks' bytes unchanged), ``serve()`` of 16 requests on that
   handle (no prefill), and int8/fp8 pools against the bf16 pool;
5. ``generate`` and ``generate_stepwise`` on ``llama3-8b`` at full width,
   cut to the 4 layers of the gateway's cloud tier;
6. the tie budget: stepwise-vs-generate readings over several prompt seeds
   for both models must lie inside it, and a generate whose decode never
   writes its K/V to the cache must lie outside it (milder wrong paths are
   read and reported);
7. Algorithm 1: the gateway (``launch/serve.gateway_from_weights``) at
   published widths — probe ``smollm-135m`` (30 layers), peers the probe,
   ``swarm-edge-1b`` (22 layers) and ``qwen1.5-110b`` (2 layers), cloud
   ``llama3-8b`` (4 layers), the safety classifier — with random weights
   from ``torch.Generator`` seeds; tau from ``calibrate_thresholds``, sigma
   at the median s of the study workload; ``answer_batch`` on the 50-query
   study workload (every route must occur, u and s in [0, 1], one probe
   prefill per batch), then ``run_edge_only`` and ``run_cloud_only``, with
   the wall time per batch and per tier; then (7p) the same gateway on
   paged engines (``engine_kw=dict(paged=True, pool_blocks=1024)``, as the
   reference CLI's ``--paged``): the same ``s``, ``u`` within 1e-2 and
   every route that differs from phase 7's at a ``u`` within 1e-2 of a
   threshold, every tier decoding through row 5 and never through row 2,
   the probe's pool back at its blocks in use after each batch;
8. ``transformer.forward`` of ``smollm-135m`` at full width (B=8, S=256)
   against the same forward with the grid-offset op's plain version
   swapped in, within the tie budget;
T1. training at published width: ``training.train.build_train_step`` on
   ``smollm-135m`` (30 layers) and ``llama3-8b`` cut to the cloud tier's 4
   layers (vocabulary 128256), AdamW lr 3e-4, batch 8, seq 128, 30 steps of
   ``SyntheticLMPipeline`` batches: the loss must fall (mean of the last 5
   below the first 5), every parameter must change, and no kernel and no
   plain version may run (training attends through ``chunked_attention``);
   ms per step, tokens/s, model TFLOP/s (6 N tokens / time) beside 989,
   peak memory and the device busy share of a step (``torch.profiler``);
T2. checkpoint and restart through the CLI: ``python -m
   repro_torch.launch.train --arch smollm-135m --steps 40 --batch 8 --seq
   128 --ckpt-every 20`` run to its end, and the same run killed once it
   prints ``[train] checkpoint @ 20`` and restarted with ``--resume``: the
   two ``step_40`` checkpoints must hold bitwise-equal parameters and
   optimizer state; save and restore seconds and bytes of one checkpoint;
T3. the trained gateway, the paper's study: ``launch.serve.build_gateway(
   train_steps=400)`` (the reference CLI's default) trains the four smoke
   tiers (vocabulary 512) and the classifier and calibrates tau; every
   tier's final loss must be finite and below its first, ``answer_batch``
   on the study workload must take every route with ``u`` spanning more
   than 100x the random-weight span (1e-2) and launch rows 1-4 and no plain
   version; then the same weights on paged engines (``engine_kw=dict(
   paged=True, pool_blocks=1024)``): the same ``s``, ``u`` within 1e-2, row
   5 launched and row 2 not; Tables III-V of both, ``run_edge_only`` and
   ``run_cloud_only`` beside them, the training seconds per tier;
9. the ``kernels`` line, then the result line.

Phase 3 also holds rows 1-3 and 5 at the trained gateway's shapes (every
smoke tier's heads at head_dim 16, B=50, S=8, T=128, V=512) before T3
serves them.

Every path of phases 4-8 runs with the kernels' launch counts set to 0 just
before it and read just after: each kernel the path runs must have launched,
and no plain version may have run.  The ``kernels`` line gives the counts of
the main path's runs — rows 1-4 from one gateway ``answer_batch``, row 5
from one paged gateway ``answer_batch`` (7p) — with every path's counts
beside them; its times and bounds are those of phase 3's case at the probe
tier's gateway shape (rows 1-3 and 5) and at the safety encoder's (row 4),
and its error the largest over all cases.

Without a CUDA device, or without the repository's sources beside this
file, it exits nonzero and prints no result.  Details of the run go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor FLOP/s, and the
# f32 rate outside the tensor cores for the probe's f32 logits
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SEED = 0
# Tie-aware budget for full-width bf16 logits: the larger of 0.03 and 4 bf16
# ulps at the row's largest logit.  Another batch or absorption shape changes
# cuBLAS's summation order, which moves bf16 activations by an ulp and the
# logits by a few; random-weight llama3-8b logits reach ~6 (lm_head std 0.02
# times sqrt(4096)), where one ulp is 0.03.  Phase 6 holds the budget
# between the readings of sound paths and those of a wrong one on every run.
# The reference's smoke budget, on logits of size ~1, is 0.01.
TIE_ATOL = 0.03
TIE_ULPS = 4
SERVE_KERNELS = ("flash_attention_positions", "decode_attention",
                 "swarm_uncertainty")                   # one tier's generate
MONO_KERNELS = SERVE_KERNELS + ("flash_attention",)     # + the safety gate
KERNELS = MONO_KERNELS + ("paged_decode_attention",)
DECODE_ONLY = ("decode_attention", "swarm_uncertainty")   # stepwise paths
PAGED_SERVE = ("flash_attention_positions", "paged_decode_attention",
               "swarm_uncertainty")                     # a paged generate
PAGED_KERNELS = PAGED_SERVE + ("flash_attention",)      # the paged gateway


def demangle(names: list[str]) -> dict[str, str]:
    """C++ names through ``c++filt`` where the machine has it."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = names
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def ptxas_lines(report: str) -> list[tuple[str, str]]:
    """(kernel, line) for each ``-Xptxas -v`` line of registers, shared
    memory or spills, named by the entry function it belongs to."""
    import re
    fn, rows = "?", []
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            fn = m.group(1)
        elif "Used" in ln or "spill" in ln:
            rows.append((fn, ln.strip()))
    names = demangle(sorted({fn for fn, _ in rows}))
    return [(names[fn].replace("(anonymous namespace)::", ""), ln)
            for fn, ln in rows]


def sass_ops(lib, nvcc: str, ops: tuple) -> dict:
    """Per function of the shared library ``lib``: how many SASS
    instructions start with each of ``ops`` (``cuobjdump -sass``)."""
    import re
    tool = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
            if m:
                for op in ops:
                    out[fn][op] += m.group(1).startswith(op)
    return out


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def tie_reading(out_tokens, ref_tokens, ref_logits, out_logits=None):
    """Compare two greedy runs tie-aware (tests/test_continuation.py's rule,
    with the flip's own logits held too): tokens agree up to the first
    mismatch, the logits up to and at it differ by at most atol (those at
    it come from the same tokens in both runs), and at it the reference's
    top-2 logit gap is at most 2 * atol (atol per row as TIE_ATOL above
    says).

    Returns (rows that diverged, reading, largest logit difference up to a
    flip): the reading is, over rows, the largest ratio of the least atol
    that passes the row to the row's atol.  The runs agree when it is <= 1."""
    import numpy as np
    flips, reading, dmax = 0, 0.0, 0.0
    for b in range(ref_tokens.shape[0]):
        atol = max(TIE_ATOL, TIE_ULPS * bf16_ulp(
            float(np.abs(ref_logits[b]).max())))
        o, r = np.asarray(out_tokens[b]), np.asarray(ref_tokens[b])
        n = min(len(o), len(r))
        mism = np.where(o[:n] != r[:n])[0]
        m = mism[0] if len(mism) else n
        need = 0.0
        if out_logits is not None and min(m + 1, n):
            k = min(m + 1, n)              # the logits up to and at the flip
            need = float(np.abs(out_logits[b, :k] - ref_logits[b, :k]).max())
            dmax = max(dmax, need)
        if len(mism):
            top2 = np.sort(ref_logits[b, m])[-2:]
            need = max(need, float(top2[1] - top2[0]) / 2)
            flips += 1
        reading = max(reading, need / atol)
    return flips, reading, dmax


def tie_aware(label, *args):
    flips, reading, dmax = tie_reading(*args)
    check(reading <= 1.0, f"{label}: not tie-aware equal (reading "
                          f"{reading:.3f} of the budget, logits differ by "
                          f"{dmax} before a flip, {flips} rows flipped)")
    return flips, reading, dmax


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch import configs
        from repro_torch.core import router
        from repro_torch.core import safety as safety_lib
        from repro_torch.core.budget import init_budget
        from repro_torch.core.uncertainty import UncertaintyConfig
        from repro_torch.kernels import build
        from repro_torch.kernels.decode_attention import ops as dops
        from repro_torch.kernels.decode_attention import ref as dref
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.flash_attention import ref as fref
        from repro_torch.kernels.swarm_uncertainty import ops as uops
        from repro_torch.kernels.swarm_uncertainty import ref as uref
        from repro_torch.data.workload import FACT_IS, FactWorld
        from repro_torch.data.pipeline import (SyntheticLMPipeline,
                                               device_put_batch)
        from repro_torch.launch import serve as serve_mod
        from repro_torch.launch.serve import (TIERS, gateway_from_weights,
                                              tier_configs)
        from repro_torch.training import checkpoint as ck
        from repro_torch.training import optimizer as opt
        from repro_torch.training import train as TR
        from repro_torch.models import attention
        from repro_torch.models import quant as TQ
        from repro_torch.models import transformer
        from repro_torch.models.common import use_f32_accumulation
        from repro_torch.models.transformer import init_params
        from repro_torch.serving import gateway as gateway_mod
        from repro_torch.serving.engine import InferenceEngine, bucket_len
        from repro_torch.serving.scheduler import Request
        from repro_torch.serving.swarm import pad_prompts
    except ImportError as e:
        fail(f"the port's sources are not beside this script ({e})")

    use_f32_accumulation()         # the plain versions of phase 3 too
    dev = torch.device("cuda")
    report: dict = {}

    # ---- 1. the card ---------------------------------------------------
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi unavailable"
    print(f"[1] device {device_name}")
    print(f"[1] nvidia-smi: {smi_line}")
    report["device"] = {"name": device_name, "nvidia_smi": smi_line,
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    t_build = time.perf_counter() - t0
    print(f"[2] built {len(built)} libraries ({len(build.SIGNATURES)} "
          f"kernel entry points) in {t_build:.1f} s")
    for k, info in built.items():
        print(f"[2] {k}: {info['seconds']:.1f} s")
        for fn, line in ptxas_lines(info["ptxas"]):
            print(f"[2] {k} {fn}: {line}")
    # the bf16 flash bodies must run on wgmma (HGMMA) fed by TMA (UTMALDG)
    sass = sass_ops(built["flash_attention"]["path"], build.nvcc(),
                    ("HGMMA", "UTMALDG"))
    tc_fns = {fn: ops for fn, ops in sass.items() if "flash_tc" in fn}
    check(len(tc_fns) == 6, f"flash library: {len(tc_fns)} tensor-core "
                            "instantiations, want 6 (D 64/128/256 x 2 modes)")
    for fn, ops in tc_fns.items():
        print(f"[2] SASS {fn}: {ops['HGMMA']} HGMMA, {ops['UTMALDG']} "
              "UTMALDG")
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0,
              f"{fn}: no HGMMA or no UTMALDG in its SASS")
    # the bf16 decode bodies must run on mma.sync (HMMA) fed by cp.async
    # (LDGSTS): rows 2 and 5 at D 32/64/128/256, row 5 for bf16, int8 and
    # fp8 pools
    sass = sass_ops(built["decode_attention"]["path"], build.nvcc(),
                    ("HMMA", "LDGSTS"))
    dec_fns = {fn: ops for fn, ops in sass.items() if "decode_tc" in fn}
    check(len(dec_fns) == 16, f"decode library: {len(dec_fns)} tensor-core "
                              "instantiations, want 16 (D 32/64/128/256 x "
                              "row 2 and row 5's three pool types)")
    for fn, ops in dec_fns.items():
        print(f"[2] SASS {fn}: {ops['HMMA']} HMMA, {ops['LDGSTS']} LDGSTS")
        check(ops["HMMA"] > 0 and ops["LDGSTS"] > 0,
              f"{fn}: no HMMA or no LDGSTS in its SASS")
    report["build_s"] = t_build
    report["flash_sass"] = tc_fns
    report["decode_sass"] = dec_fns

    # ---- 3. kernels vs plain versions ----------------------------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2

    def time_ms(fn, iters=20):
        """Median device time of one call with a cold L2: a spin kernel
        keeps the stream busy while the host enqueues the call."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(5_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return float(np.median(ts))

    def bound(nbytes, nops, peak):
        tb, to = nbytes / HBM_BPS * 1e3, nops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    checks = []
    world = FactWorld(n_ent=16, n_rel=6)      # build_gateway's fact world

    def flash_case(label, B, S, H, K, D, n_pad, main=False):
        q, k, v = randn(B, S, H, D), randn(B, S, K, D), randn(B, S, K, D)
        pos = (torch.arange(S, device=dev, dtype=torch.int32) - n_pad)
        kw = dict(q_positions=pos, kv_positions=pos)
        out = fops.flash_attention_positions(q, k, v, **kw)
        ref = fref.flash_attention_positions_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        # padding rows (negative positions) are the mean of v
        G = H // K
        mv = v.float().mean(1).repeat_interleave(G, dim=1)      # (B, H, D)
        pad_err = float((out[:, :n_pad].float() - mv[:, None]).abs().max())
        check(pad_err <= 2e-2, f"{label}: padding rows {pad_err} from mean(v)")
        qp, kp = pos[:, None], pos[None, :]
        mask = (kp >= 0) & (qp >= kp)                            # (S, S)
        n_valid = int(mask.sum())
        mask_sd = mask.clone()
        mask_sd[pos < 0] = True        # SDPA needs >= 1 key per row
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask_sd, enable_gqa=True)
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D) + 8 * S
        nops = 4 * D * n_valid * H * B
        b_ms, b_by = bound(nbytes, nops, BF16_FLOPS)
        ms = time_ms(lambda: fops.flash_attention_positions(q, k, v, **kw))
        return dict(name="flash_attention_positions", label=label, main=main,
                    max_abs_err=err, tol=2e-2, ms=ms, tflops=nops / ms / 1e9,
                    plain_ms=time_ms(lambda: fref.flash_attention_positions_ref(
                        q, k, v, **kw)),
                    library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)

    def continuation_case(label, B, S, T, H, K, D, p0):
        """Row 1 over a warm cache (the fan-out's continuation): S span
        queries at positions p0.., a T-slot cache holding positions
        0..p0+S-1, its tail slots empty (-1)."""
        q, k, v = randn(B, S, H, D), randn(B, T, K, D), randn(B, T, K, D)
        ar = torch.arange(T, device=dev, dtype=torch.int32)
        kvpos = torch.where(ar < p0 + S, ar, -1).to(torch.int32)
        qpos = torch.arange(p0, p0 + S, device=dev, dtype=torch.int32)
        kw = dict(q_positions=qpos, kv_positions=kvpos)
        out = fops.flash_attention_positions(q, k, v, **kw)
        ref = fref.flash_attention_positions_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        mask = (kvpos[None] >= 0) & (qpos[:, None] >= kvpos[None])
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
        nbytes = 2 * (2 * B * S * H * D + 2 * B * T * K * D) + 4 * (S + T)
        nops = 4 * D * int(mask.sum()) * H * B
        b_ms, b_by = bound(nbytes, nops, BF16_FLOPS)
        ms = time_ms(lambda: fops.flash_attention_positions(q, k, v, **kw))
        return dict(name="flash_attention_positions", label=label, main=False,
                    max_abs_err=err, tol=2e-2, ms=ms, tflops=nops / ms / 1e9,
                    plain_ms=time_ms(lambda: fref.flash_attention_positions_ref(
                        q, k, v, **kw)),
                    library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)

    def grid_case(label, B, S, H, K, D, causal, window=None, main=False):
        """Row 4, the grid-offset op: masks from query row / key column."""
        q, k, v = randn(B, S, H, D), randn(B, S, K, D), randn(B, S, K, D)
        kw = dict(causal=causal, window=window)
        out = fops.flash_attention(q, k, v, **kw)
        ref = fref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        i = torch.arange(S, device=dev)
        mask = torch.ones((S, S), dtype=torch.bool, device=dev)
        if causal:
            mask &= i[:, None] >= i[None, :]
        if window is not None:
            mask &= i[:, None] - i[None, :] < window
        n_valid = int(mask.sum())          # the pairs this mask needs
        sd = dict(is_causal=True) if causal and window is None else (
            dict(attn_mask=mask) if window is not None else {})
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True, **sd)
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D)
        nops = 4 * D * n_valid * H * B
        b_ms, b_by = bound(nbytes, nops, BF16_FLOPS)
        ms = time_ms(lambda: fops.flash_attention(q, k, v, **kw))
        return dict(name="flash_attention", label=label, main=main,
                    max_abs_err=err, tol=2e-2, ms=ms, tflops=nops / ms / 1e9,
                    plain_ms=time_ms(lambda: fref.flash_attention_ref(
                        q, k, v, **kw)),
                    library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)

    def decode_case(label, B, T, K, G, D, main=False, fill=None):
        """Row 2 over a T-slot cache: slots 0..index hold their positions,
        the rest are empty (-1), row 0 sees no key.  The index is drawn
        from [T/2, T), or with ``fill`` = (n_pad, lo, hi) from [lo, hi)
        with the first n_pad slots padding (-1): the gateway's cache at a
        decode step."""
        q, k, v = randn(B, K, G, D), randn(B, T, K, D), randn(B, T, K, D)
        lo, hi = (T // 2, T) if fill is None else fill[1:]
        idx = torch.randint(lo, hi, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        ar = torch.arange(T, device=dev, dtype=torch.int32)
        pos = torch.where(ar[None] <= idx[:, None], ar[None],
                          -1).to(torch.int32).contiguous()
        if fill is not None:
            pos[:, :fill[0]] = -1                    # bucket padding
        pos[0] = -1                                  # a row with no valid slot
        out = dops.decode_attention(q, k, v, pos, idx)
        ref = dref.decode_attention_ref(q, k, v, pos, idx)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        valid = (pos >= 0) & (pos <= idx[:, None])
        n_valid = int(valid.sum())
        vmask = valid.clone()
        vmask[0] = True
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.reshape(B, K * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=vmask[:, None, None, :], enable_gqa=True)
        # the bound counts what this run's data needs: q, out, every
        # position and index, and k/v of the valid slots only
        nbytes = 2 * (2 * B * K * G * D + 2 * n_valid * K * D) + 4 * (B * T
                                                                      + B)
        b_ms, b_by = bound(nbytes, 4 * D * n_valid * K * G, BF16_FLOPS)
        return dict(name="decode_attention", label=label, main=main,
                    max_abs_err=err, tol=2e-2,
                    ms=time_ms(lambda: dops.decode_attention(q, k, v, pos,
                                                             idx)),
                    plain_ms=time_ms(lambda: dref.decode_attention_ref(
                        q, k, v, pos, idx)),
                    library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)

    def uncertainty_case(label, B, V, main=False, dtype=torch.float32,
                         k=10):
        """Row 3 over (B, 1, V) logits: row 0 holds 12 duplicates of its
        maximum, row 4 six tied maxima across its first split boundary."""
        lg = randn(B, 1, V, dtype=torch.float32, scale=3.0)
        lg[0, 0, :12] = lg[0, 0].max()              # duplicate top-k values
        plan = uops.uncertainty_plan(B, V, k, dtype)
        check(plan.splits > 1 or V < 32000,
              f"{label}: a row of {V} logits is not split")
        edge = plan.bounds(1)[0] if plan.splits > 1 else V // 2
        lg[4, 0, edge - 3:edge + 3] = lg[4, 0].max() + 1.0
        lg = lg.to(dtype)
        tok = torch.randint(0, V, (B, 1), generator=gen, device=dev,
                            dtype=torch.int32)
        # rows 0-4 choose a likely token (one of row 0's tied maxima, row
        # 1's argmax, rows 2-3's 2nd and 5th largest, row 4's tied maximum
        # right of the boundary), so Eq. 2's -p log p is ~0.1, not the ~1e-6
        # of a random token; it is held at a relative tolerance, and a
        # wrong chosen logit or log p cannot pass
        top = torch.topk(lg[:, 0].float(), 5, dim=-1).indices
        tok[0, 0] = 3
        tok[1:4, 0] = top[[1, 2, 3], [0, 1, 4]].to(torch.int32)
        tok[4, 0] = edge
        out = uops.uncertainty(lg, tok, k=k)
        ref = uref.uncertainty_ref(lg, tok, k=k)
        torch.cuda.synchronize()
        check(float(ref[0][:5].min()) > 1e-3, f"{label}: chosen tokens "
                                              "unlikely")
        h_rel = float(((out[0] - ref[0]).abs()
                       / (ref[0].abs() + 1e-7 / 1e-4)).max())
        check(bool(torch.isclose(out[0], ref[0], rtol=1e-4, atol=1e-7).all()),
              f"{label}: h outside rtol 1e-4 / atol 1e-7 (relative error "
              f"{h_rel:.2e})")
        errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
        for e, t, n in zip(errs[1:], (5e-3, 1e-4), ("v", "h_dist")):
            check(e <= t, f"{label}: {n} error {e} > {t}")
        nbytes = lg.element_size() * B * V + 4 * B + 12 * B
        b_ms, b_by = bound(nbytes, 6 * B * V, F32_FLOPS)
        return dict(name="swarm_uncertainty", label=label, main=main,
                    max_abs_err=max(errs), tol=5e-3, h_rel_err=h_rel,
                    splits=plan.splits, chunk=plan.chunk,
                    ms=time_ms(lambda: uops.uncertainty(lg, tok, k=k)),
                    plain_ms=time_ms(lambda: uref.uncertainty_ref(
                        lg, tok, k=k)),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by)

    def paged_case(label, B, K, G, D, *, nb=2, L=64, S=8, p0=8, N=1024,
                   window=None, quant=None, share=4, main=False):
        """Row 5 at one decode step of a dispatch: an N-block bf16 (or
        int8/fp8) pool, B rows of ``nb`` table entries (rows 0..share-1
        share their first block, the last row's tail is a sentinel), the
        dispatch's S delta rows from position p0, the step at its last row.
        Linear slots hold position = slot up to the step (the covered ones
        a stale row); a ring (``window``) slot holds the latest position
        before p0 on it.  Every row sees at least its delta rows."""
        H, Tl = K * G, nb * L
        q = randn(B, K, G, D)
        kp, vp = randn(N, L, K, D), randn(N, L, K, D)
        table = torch.randperm(N, generator=gen, device=dev)[:B * nb]
        table = table.view(B, nb).to(torch.int32)
        table[1:share, 0] = table[0, 0]
        idx = torch.full((B,), p0 + S - 1, dtype=torch.int32, device=dev)
        p0t = torch.full((B,), p0, dtype=torch.int32, device=dev)
        sl = torch.arange(Tl, dtype=torch.int32, device=dev)
        if window is None:
            lin = torch.where(sl <= p0 + S - 1, sl, -1)
        else:
            lin = sl + Tl * torch.div(p0 - 1 - sl, Tl, rounding_mode="floor")
            lin = lin.clamp(min=-1)
        pos = torch.full((N, L), -1, dtype=torch.int32, device=dev)
        pos[table.reshape(-1).long()] = lin.expand(B, Tl).reshape(B * nb, L)
        table[-1, -1] = N                          # a sentinel tail
        dk, dv = randn(B, S, K, D), randn(B, S, K, D)
        dpos = (p0 + torch.arange(S, dtype=torch.int32, device=dev)).expand(
            B, S).contiguous()
        kw = dict(window=window, delta_k=dk, delta_v=dv, delta_pos=dpos,
                  p0=p0t)
        elem = 2
        if quant is not None:
            kp, ks = TQ.quantize_rows(kp, quant)
            vp, vs = TQ.quantize_rows(vp, quant)
            kw.update(k_scale=ks, v_scale=vs)
            elem = 1
        args = (q, kp, vp, pos, table, idx)
        out = dops.paged_decode_attention(*args, **kw)
        ref = dref.paged_decode_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        # the library yardstick: SDPA over the same keys pre-gathered
        # (untimed) into a monolithic bf16 view, with the same mask
        kl, vl, pl = dref.paged_gathered_view(*args[1:], **kw)
        kl, vl = kl.to(torch.bfloat16), vl.to(torch.bfloat16)
        valid = (pl >= 0) & (pl <= idx[:, None])
        if window is not None:
            valid &= idx[:, None] - pl < window
        check(bool(valid.any(1).all()), f"{label}: a row sees no key")
        Tl_valid = valid[:, :Tl]
        if window is not None and S < Tl:
            check(bool(Tl_valid.any(1).all()),
                  f"{label}: the ring mask lets no pool row through")
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.reshape(B, H, 1, D), kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=valid[:, None, None, :], enable_gqa=True)
        # the bound counts what this run's data needs: table, q, out,
        # index and p0; pos of every distinct visited block; k/v (and
        # scales) of every distinct pool row some table row attends (valid,
        # not covered); delta pos, and delta k/v of the valid delta rows.
        # Operations: the valid keys only
        blocks = torch.unique(table[table < N]).numel()
        slot_ids = (table.long().repeat_interleave(L, dim=1) * L
                    + torch.arange(L, device=dev).repeat(nb))
        kv_rows = torch.unique(slot_ids[Tl_valid]).numel()
        delta_rows = int(valid[:, Tl:].sum())
        nbytes = (4 * B * nb + 2 * 2 * B * H * D + 8 * B + blocks * L * 4
                  + kv_rows * (2 * K * D * elem + (8 * K if quant else 0))
                  + B * S * 4 + delta_rows * 2 * K * D * 2)
        b_ms, b_by = bound(nbytes, 4 * H * D * int(valid.sum()), BF16_FLOPS)
        return dict(name="paged_decode_attention", label=label, main=main,
                    max_abs_err=err, tol=2e-2,
                    ms=time_ms(lambda: dops.paged_decode_attention(
                        *args, **kw)),
                    plain_ms=time_ms(lambda: dref.paged_decode_attention_ref(
                        *args, **kw)),
                    library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)

    # the gateway's shapes, those of phase 7's counted run (the main path):
    # every tier at its own widths, the 50 study prompts of 4-6 tokens
    # bucketed to S_GW (2 padding columns), decode over the engine's
    # default T_GW-slot cache, one uncertainty row per query and step.  The
    # swarm members and the cloud tier serve the queries routed to them, a
    # data-dependent subset: they are held here at all 50
    nq = len(world.study_workload())
    s_raw = max(len(q["prompt"]) for q in world.study_workload())
    gw_cases = []
    for name, tc in tier_configs().items():
        H, K, D = tc.num_heads, tc.num_kv_heads, tc.head_dim
        S_GW = bucket_len(s_raw, max(tc.attn_q_block, tc.attn_kv_block))
        T_GW = InferenceEngine.max_len
        probe_tier = name == "probe"
        gw_cases += [
            flash_case(f"gateway {tc.name} prefill B{nq} S{S_GW}", nq, S_GW,
                       H, K, D, S_GW - s_raw, main=probe_tier),
            decode_case(f"gateway {tc.name} decode B{nq} T{T_GW}", nq, T_GW,
                        K, H // K, D, main=probe_tier),
            decode_case(f"gateway {tc.name} decode B{nq} T{T_GW} fill 8-15",
                        nq, T_GW, K, H // K, D,
                        fill=(S_GW - s_raw, S_GW, S_GW + 8)),
            uncertainty_case(f"gateway {tc.name} B{nq} V{tc.vocab_size}",
                             nq, tc.vocab_size, main=probe_tier),
            # row 5 at the paged gateway's decode: the 128-slot cache in
            # blocks of 64, the last of 8 steps after an 8-column prefill
            paged_case(f"paged gateway {tc.name} decode B{nq} L64 nb2 S8",
                       nq, K, H // K, D, main=probe_tier)]
    # the trained gateway's shapes (T3): every tier at its smoke widths
    # (head_dim 16) and vocabulary 512, the same batch, buckets and caches
    for name, (arch, _) in TIERS.items():
        tc = dataclasses.replace(configs.get_smoke(arch), vocab_size=512)
        H, K, D = tc.num_heads, tc.num_kv_heads, tc.head_dim
        S_TR = bucket_len(s_raw, max(tc.attn_q_block, tc.attn_kv_block))
        T_TR = InferenceEngine.max_len
        gw_cases += [
            flash_case(f"trained {tc.name} prefill B{nq} S{S_TR}", nq, S_TR,
                       H, K, D, S_TR - s_raw),
            decode_case(f"trained {tc.name} decode B{nq} T{T_TR} fill 8-15",
                        nq, T_TR, K, H // K, D,
                        fill=(S_TR - s_raw, S_TR, S_TR + 8)),
            uncertainty_case(f"trained {tc.name} B{nq} V512", nq, 512),
            paged_case(f"paged trained {tc.name} decode B{nq} L64 nb2 S8",
                       nq, K, H // K, D)]
    pc = tier_configs()["probe"]
    PK, PG, PD = pc.num_kv_heads, pc.num_heads // pc.num_kv_heads, pc.head_dim
    cases = [
        # the shapes of phases 4-5: the probe tier's generate and llama3-8b's
        flash_case("smollm prefill B8 S128", 8, 128, 9, 3, 64, 40),
        flash_case("smollm prefill B8 S256 (generate bucket)", 8, 256, 9, 3,
                   64, 56),
        flash_case("llama3 prefill B8 S256", 8, 256, 32, 8, 128, 56),
        # phase 4p's fan-out: 12-token spans over a 320-slot warm cache
        continuation_case("smollm continuation B16 S12 T320", 16, 12, 320,
                          9, 3, 64, 200),
        decode_case("smollm decode B8 T256", 8, 256, 3, 3, 64),
        decode_case("smollm decode B8 T320 (generate cache)", 8, 320, 3, 3,
                    64),
        decode_case("llama3 decode B8 T320", 8, 320, 8, 4, 128),
        uncertainty_case("probe B8 V49152", 8, 49152),
        uncertainty_case("llama3 B8 V128256", 8, 128256),
        # row 3's edge cases: an odd vocabulary (no row starts 16-byte
        # aligned), k = 1 and 16 (the generic list), bf16 logits
        uncertainty_case(f"odd vocabulary B{nq} V50257", nq, 50257),
        uncertainty_case(f"probe B{nq} V49152 k=1", nq, 49152, k=1),
        uncertainty_case(f"probe B{nq} V49152 k=16", nq, 49152, k=16),
        uncertainty_case(f"probe B{nq} V49152 bf16", nq, 49152,
                         dtype=torch.bfloat16),
        *gw_cases,
        # row 5: quantized pools, a ring that the dispatch covers in part
        # and one it covers whole (steps > ring length), 512 slots
        *(paged_case(f"paged smollm {qm} pool B{nq} L64 nb2 S8", nq, PK, PG,
                     PD, quant=qm) for qm in ("int8", "fp8")),
        paged_case("paged smollm ring window 128 B8 nb2 S8", 8, PK, PG, PD,
                   p0=300, window=128),
        paged_case("paged smollm ring window 128 B8 nb2 S160", 8, PK, PG, PD,
                   S=160, p0=300, window=128),
        paged_case("paged smollm B8 nb8 (T512) S8", 8, PK, PG, PD, nb=8,
                   p0=400),
        # row 4: the safety gate's own shape (the main path), then the
        # full-sequence forward at S=2048
        grid_case(f"safety encoder B{nq} S{s_raw} H4 D32 bidirectional", nq,
                  s_raw, 4, 4, 32, causal=False, main=True),
        grid_case("smollm forward B8 S2048 causal", 8, 2048, 9, 3, 64,
                  causal=True),
        grid_case("llama3 forward B2 S2048 causal", 2, 2048, 32, 8, 128,
                  causal=True),
        grid_case("smollm B2 S2048 causal window 512", 2, 2048, 9, 3, 64,
                  causal=True, window=512),
        grid_case("smollm B8 S512 bidirectional", 8, 512, 9, 3, 64,
                  causal=False),
    ]
    for c in cases:
        check(c["max_abs_err"] <= c["tol"],
              f"{c['label']}: error {c['max_abs_err']} > {c['tol']}")
        lib = ("-" if c["library_ms"] is None
               else f"{c['library_ms']:.4f}")
        rel = (f", h relative {c['h_rel_err']:.2e} (rtol 1e-4)"
               if "h_rel_err" in c else "")
        rate = (f" ({c['tflops']:.1f} TFLOP/s)" if "tflops" in c else "")
        split = (f", {c['splits']} splits of {c['chunk']}"
                 if "splits" in c else "")
        print(f"[3] {c['label']}: err {c['max_abs_err']:.2e} (tol "
              f"{c['tol']:g}{rel}) kernel {c['ms']:.4f} ms{rate} plain "
              f"{c['plain_ms']:.4f} ms library {lib} ms bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']}){split}")
        checks.append(c)
    report["kernel_checks"] = checks

    # the model path on a small input, held to the port's plain path on the
    # CPU, in both uncertainty modes (outside the counted windows: the CPU
    # run calls the plain versions)
    cfg = configs.get_config("smollm-135m")
    ucfg = UncertaintyConfig(alpha=1.0, mode="distribution")
    tcfg = UncertaintyConfig(alpha=1.0, mode="token")
    small = dataclasses.replace(cfg, num_layers=2)
    sm = init_params(small, torch.Generator(device=dev).manual_seed(SEED + 1),
                     device=dev)
    small_prompts = torch.randint(1, cfg.vocab_size, (2, 24), generator=gen,
                                  device=dev, dtype=torch.int32).cpu().numpy()
    sm_cpu = copy.deepcopy(sm).cpu()
    small_check = {}
    for uc in (ucfg, tcfg):
        cpu_ref = InferenceEngine("cpu", small, sm_cpu, uc,
                                  device="cpu").generate(small_prompts, 8)
        gpu_out = InferenceEngine("gpu", small, sm, uc).generate(
            small_prompts, 8)
        glog = gpu_out["logits"]
        flips, reading, dlog = tie_aware(
            f"2-layer smollm ({uc.mode}) on the card vs the CPU path",
            gpu_out["tokens"], cpu_ref["tokens"],
            cpu_ref["logits"].float().numpy(), glog.float().cpu().numpy())
        # the card's Eq. 2-3 means against the plain version of the card's
        # own logits and tokens: f32 summation order only
        h, v, hd = uref.uncertainty_ref(
            glog, torch.as_tensor(gpu_out["tokens"], device=dev), k=10)
        want_h = (h if uc.mode == "token" else hd).mean(-1).cpu().numpy()
        check(np.allclose(gpu_out["h_mean"], want_h, rtol=1e-4, atol=1e-9)
              and np.allclose(gpu_out["v_mean"], v.mean(-1).cpu().numpy(),
                              rtol=1e-4, atol=1e-5),
              f"{uc.mode}: the engine's probe means differ from the plain "
              "version of its logits")
        # against the CPU path: a logit moved by d moves log p of the chosen
        # token by at most 2d, and -p log p relatively by about as much
        dh = float(np.abs(gpu_out["h_mean"] / cpu_ref["h_mean"] - 1).max())
        if not flips:
            check(dh <= 2.5 * dlog + 1e-4, f"{uc.mode}: h_mean differs from "
                  f"the CPU path by {dh:.2e} (logits by {dlog:.2e})")
        print(f"[3] 2-layer smollm ({uc.mode}) on the card vs the CPU path: "
              f"tie-aware equal ({flips} rows diverged at a tie, reading "
              f"{reading:.3f}), logits {dlog:.2e}, h_mean relative "
              f"{dh:.2e}, u {float(np.abs(gpu_out['u'] - cpu_ref['u']).max()):.2e}")
        small_check[uc.mode] = {"flips": flips, "reading": reading,
                                "max_dlogit": dlog, "h_mean_rel": dh}
    report["small_vs_cpu"] = small_check
    del sm, sm_cpu

    # ---- counted paths -------------------------------------------------
    counts_of = dict(zip(KERNELS, (fops.counts, dops.counts, uops.counts,
                                   fops.grid_counts, dops.paged_counts)))
    path_launches: dict[str, dict[str, int]] = {}

    def counted(path, needs, fn, forbid=()):
        """Run one path with every kernel count set to 0 just before it and
        read just after: each kernel the path runs (``needs``) must have
        launched, none of ``forbid`` may have, and no plain version may
        have run."""
        for c in counts_of.values():
            c.reset()
        out = fn()
        torch.cuda.synchronize()
        got = {n: c.launches for n, c in counts_of.items()}
        for n in needs:
            check(got[n] > 0, f"{path}: {n} was never launched")
        for n in forbid:
            check(got[n] == 0, f"{path}: {n} launched {got[n]} times")
        for n, c in counts_of.items():
            check(c.plain == 0, f"{path}: {c.plain} calls of {n}'s plain "
                                "version")
        path_launches[path] = got
        print(f"[k] {path}: launches {got}")
        return out

    # ---- 4. the probe tier: smollm-135m, full width and depth ----------
    V = cfg.vocab_size
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    probe = InferenceEngine("probe-smollm", cfg, model, ucfg)
    rng = np.random.default_rng(SEED)
    lens = [24, 200] + list(rng.integers(24, 201, 6))
    raw = [list(rng.integers(1, V, n)) for n in lens]
    S = max(lens)
    prompts = np.zeros((len(raw), S), np.int32)
    for i, p in enumerate(raw):
        prompts[i, S - len(p):] = p                 # left-padded with PAD=0
    max_new = 32

    probe.generate(prompts[:2], 2)                  # warm up cuBLAS et al.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe.generate(prompts, 1)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = counted("smollm generate", SERVE_KERNELS,
                  lambda: probe.generate(prompts, max_new),
                  forbid=("paged_decode_attention",))
    t_gen = time.perf_counter() - t0
    per_tok = (t_gen - t_one) / (max_new - 1)
    t_prefill = t_one - per_tok
    toks, u = res["tokens"], res["u"]
    logits = res["logits"].float().cpu().numpy()
    check(toks.shape == (8, max_new) and toks.min() >= 0 and toks.max() < V,
          "generate tokens out of range")
    check(bool(np.isfinite(logits).all()), "generate logits not finite")
    check(bool(np.isfinite(u).all() and (u >= 0).all() and (u <= 1).all()),
          f"u outside [0, 1]: {u}")
    print(f"[4] generate B=8 S={S} max_new={max_new}: prefill "
          f"{t_prefill * 1e3:.1f} ms, decode {per_tok * 1e3:.2f} ms/step, "
          f"{8 * max_new / t_gen:.1f} tokens/s end to end")

    # where a decode step's time goes: device kernel time from the profiler
    # (difference of a 9-step and a 1-step generate) against the unprofiled
    # wall time per step; a share well below 1 means the host holds the card
    dev_us, top = {}, []
    for steps in (1, 9):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            probe.generate(prompts, steps)
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us[steps] = sum(e.self_device_time_total for e in ka)
        top = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in ka), reverse=True)[:6]
    step_dev_ms = (dev_us[9] - dev_us[1]) / 8 / 1e3
    busy = step_dev_ms / (per_tok * 1e3) if dev_us[9] > 0 else None
    print(f"[4] decode step: device kernel time {step_dev_ms:.3f} ms of "
          f"{per_tok * 1e3:.2f} ms wall (busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'})")
    for us, key, n in top:
        print(f"[4]   9-step generate: {us / 1e3:9.3f} ms in {n:5d} x "
              f"{key[:70]}")

    t0 = time.perf_counter()
    fin = counted("smollm serve", SERVE_KERNELS, lambda: probe.serve(
        [Request(rid=i, prompt=prompts[i].tolist(), max_new=max_new)
         for i in range(8)], n_slots=4, decode_chunk=8))
    t_serve = time.perf_counter() - t0
    check(sorted(r["rid"] for r in fin) == list(range(8)),
          "serve lost a request")
    out_rows = {r["rid"]: r["tokens"] for r in fin}
    flips_serve, read_serve, _ = tie_aware(
        "serve vs generate", [out_rows[i] for i in range(8)], toks, logits)
    print(f"[4] serve n_slots=4 decode_chunk=8: {t_serve:.2f} s, tie-aware "
          f"equal to generate ({flips_serve} rows diverged at a tie)")

    two = np.argsort(lens)[:2]
    pr2 = prompts[two][:, S - max(lens[i] for i in two):]
    ref2 = probe.generate(pr2, max_new)
    t0 = time.perf_counter()
    step2 = counted("smollm generate_stepwise", DECODE_ONLY,
                    lambda: probe.generate_stepwise(pr2, max_new))
    t_step = time.perf_counter() - t0
    flips_step, read_step, d_step = tie_aware(
        "smollm stepwise vs generate", step2["tokens"], ref2["tokens"],
        ref2["logits"].float().cpu().numpy(),
        step2["logits"].float().cpu().numpy())
    print(f"[4] generate_stepwise on 2 prompts: {t_step:.2f} s, tie-aware "
          f"equal to generate ({flips_step} rows diverged at a tie, logits "
          f"{d_step:.4f} apart, reading {read_step:.3f})")

    ut = torch.as_tensor(u, dtype=torch.float32, device=dev)
    rcfg = router.RouterConfig(tau_low=float(np.quantile(u, 0.40)),
                               tau_high=float(np.quantile(u, 0.90)),
                               sigma=0.7, peers_k=2, gamma=0.3, l_max=4.0)
    rr = router.route(ut, torch.zeros_like(ut), cfg=rcfg,
                      budget=init_budget(1.0, device=dev), wan_ok=True,
                      est_cloud_cost=torch.full_like(ut, 0.1))
    dec = rr.decision.cpu().numpy()
    counts = {n: int((dec == c).sum())
              for c, n in enumerate(router.DECISION_NAMES)}
    check(sum(counts.values()) == 8, "route lost a query")
    print(f"[4] route (tau {rcfg.tau_low:.4f}/{rcfg.tau_high:.4f}): {counts}")

    report["probe"] = {
        "prompt_lengths": [int(n) for n in lens], "max_new": max_new,
        "prefill_ms": t_prefill * 1e3, "decode_ms_per_step": per_tok * 1e3,
        "generate_s": t_gen, "tokens_per_s": 8 * max_new / t_gen,
        "decode_step_device_ms": step_dev_ms, "decode_busy_share": busy,
        "profile_top_9step": [(us / 1e3, key, n) for us, key, n in top],
        "serve_s": t_serve, "stepwise_s": t_step,
        "serve_tie_flips": flips_serve, "stepwise_tie_flips": flips_step,
        "serve_tie_reading": read_serve, "stepwise_tie_reading": read_step,
        "u": [float(x) for x in u], "route": counts}

    # ---- 4p. the probe tier on a paged block pool ----------------------
    def block_bytes(eng, ids):
        """Every pool field's bytes at blocks ``ids``, all layers."""
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
        return [attention.raw(t).index_select(0, ids).clone()
                for pool in eng.pool.arrays for t in pool if t is not None]

    def paged_engine(name, **kw):
        return InferenceEngine(name, cfg, model, ucfg, paged=True,
                               pool_blocks=256, **kw)

    pprobe = paged_engine("probe-paged")
    gather_probe = paged_engine("probe-gather", attn_decode_impl="gather")
    for eng in (pprobe, gather_probe):
        eng.generate(prompts[:2], 2)                # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = counted("paged smollm generate (kernel)", PAGED_SERVE,
                   lambda: pprobe.generate(prompts, max_new),
                   forbid=("decode_attention",))
    t_pgen = time.perf_counter() - t0
    plog = pres["logits"].float().cpu().numpy()
    paged_read = {}
    paged_read["kernel"] = tie_aware(
        "paged generate (kernel) vs generate", pres["tokens"], toks, logits,
        plog)
    t0 = time.perf_counter()
    gres = counted("paged smollm generate (gather)", SERVE_KERNELS,
                   lambda: gather_probe.generate(prompts, max_new),
                   forbid=("paged_decode_attention",))
    t_ggen = time.perf_counter() - t0
    paged_read["gather"] = tie_aware(
        "paged generate (gather) vs generate", gres["tokens"], toks, logits,
        gres["logits"].float().cpu().numpy())
    print(f"[4p] paged generate B=8 max_new={max_new}: kernel {t_pgen:.2f} "
          f"s, gather {t_ggen:.2f} s (monolithic {t_gen:.2f} s); tie-aware "
          "equal to generate: " + ", ".join(
              f"{k} {f} rows diverged at a tie, logits {d:.4f} apart, "
              f"reading {r:.3f}" for k, (f, r, d) in paged_read.items()))

    sys_prompt = rng.integers(1, V, (1, 200)).astype(np.int32)
    spans = rng.integers(1, V, (16, 12)).astype(np.int32)
    c0 = dict(pprobe.counters)

    def fan_out():
        st = pprobe.absorb(sys_prompt)
        shared = st.cache.tables[0].copy()
        snap = block_bytes(pprobe, shared)
        out = pprobe.generate(spans, 16, state=pprobe.fanout(st, 16),
                              return_state=True)
        return st, shared, snap, out
    t0 = time.perf_counter()
    st, shared, snap, fres = counted(
        "paged absorb + fanout 16 + continue", PAGED_SERVE, fan_out,
        forbid=("decode_attention",))
    t_fan = time.perf_counter() - t0
    d_cold = pprobe.counters["prefill"] - c0["prefill"]
    d_cont = pprobe.counters["prefill_continue"] - c0["prefill_continue"]
    check(d_cold == 1 and d_cont == 1,
          f"fan-out: {d_cold} cold prefills and {d_cont} continuations (want "
          "1 and 1)")
    check(all(torch.equal(a, b)
              for a, b in zip(snap, block_bytes(pprobe, shared))),
          "fan-out: a shared prefix block was written through")
    cold = probe.generate(np.concatenate([np.tile(sys_prompt, (16, 1)),
                                          spans], axis=1), 16)
    fan_read = tie_aware(
        "fanned continuation vs cold concatenation", fres["tokens"],
        cold["tokens"], cold["logits"].float().cpu().numpy(),
        fres["logits"].float().cpu().numpy())
    print(f"[4p] absorb 200 tokens + fanout 16 + 12-token spans + 16 new: "
          f"{t_fan:.2f} s, {d_cold} cold prefill, {d_cont} continuation, "
          f"{pprobe.pool.counters['cow_copies']} COW copies; shared blocks "
          f"{shared.tolist()} unchanged; tie-aware equal to cold "
          f"concatenations ({fan_read[0]} rows diverged at a tie, reading "
          f"{fan_read[1]:.3f})")

    oracle = pprobe.generate(None, 12, state=pprobe.fanout(st, 1))
    c1 = dict(pprobe.counters)
    t0 = time.perf_counter()
    sfin = counted(
        "paged serve, 16 requests on one handle",
        ("paged_decode_attention", "swarm_uncertainty"),
        lambda: pprobe.serve([Request(rid=k, prompt=[], max_new=12, state=st)
                              for k in range(16)], n_slots=8,
                             decode_chunk=4),
        forbid=("decode_attention", "flash_attention_positions"))
    t_pserve = time.perf_counter() - t0
    check(len(sfin) == 16 and pprobe.counters["prefill"] == c1["prefill"]
          and pprobe.counters["prefill_continue"]
          == c1["prefill_continue"], "paged serve: a request was lost or a "
          "prefill ran")
    ol = oracle["logits"].float().cpu().numpy()
    serve_read = tie_aware(
        "paged serve on one handle vs the session's extension",
        [r["tokens"] for r in sorted(sfin, key=lambda r: r["rid"])],
        np.repeat(oracle["tokens"], 16, axis=0), np.repeat(ol, 16, axis=0))
    print(f"[4p] serve 16 requests on the absorbed handle, 8 slots: "
          f"{t_pserve:.2f} s, no prefill, tie-aware equal to the session's "
          f"decode-only extension ({serve_read[0]} rows diverged at a tie)")

    quant_read = {}
    for qm in ("int8", "fp8"):
        qeng = paged_engine(f"probe-{qm}", cache_quant=qm)
        qr = counted(f"paged smollm generate ({qm} pool)", PAGED_SERVE,
                     lambda: qeng.generate(prompts, max_new),
                     forbid=("decode_attention",))
        ql = qr["logits"].float().cpu().numpy()
        check(bool(np.isfinite(ql).all()), f"{qm} pool: non-finite logits")
        flips, _, dq = tie_reading(qr["tokens"], pres["tokens"], plog, ql)
        agree = float((qr["tokens"] == pres["tokens"]).mean())
        quant_read[qm] = {"max_dlogit_before_divergence": dq,
                          "rows_diverged": flips, "token_agreement": agree,
                          "block_bytes": qeng.pool.block_bytes}
        print(f"[4p] {qm} pool vs bf16 pool: logits {dq:.4f} apart before "
              f"a divergence, {flips} rows diverged, token agreement "
              f"{agree:.3f}, {qeng.pool.block_bytes} bytes per block (bf16 "
              f"{pprobe.pool.block_bytes})")
        del qeng
    report["paged_probe"] = {
        "generate_s": {"kernel": t_pgen, "gather": t_ggen,
                       "monolithic": t_gen},
        "tie_readings": {k: list(v) for k, v in paged_read.items()},
        "fanout_s": t_fan, "fanout_tie": list(fan_read),
        "cow_copies": pprobe.pool.counters["cow_copies"],
        "serve_s": t_pserve, "serve_tie": list(serve_read),
        "quantized": quant_read}
    del pprobe, gather_probe

    # ---- 5. the cloud tier: llama3-8b, full width, 4 layers -----------
    lcfg = dataclasses.replace(configs.get_config("llama3-8b"), num_layers=4)
    lmodel = init_params(lcfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    cloud = InferenceEngine("cloud-fm", lcfg, lmodel, ucfg)
    lp = prompts               # ids < 49152 are valid llama3 tokens too
    cloud.generate(lp[:2], 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lres = counted("llama3 generate", SERVE_KERNELS,
                   lambda: cloud.generate(lp, 16))
    t_llama = time.perf_counter() - t0
    ll = lres["logits"].float().cpu().numpy()
    check(lres["tokens"].shape == (8, 16) and bool(np.isfinite(ll).all())
          and lres["tokens"].max() < lcfg.vocab_size, "llama3 generate")
    lref = cloud.generate(lp[two][:, -24:], 8)
    lstep = counted("llama3 generate_stepwise", DECODE_ONLY,
                    lambda: cloud.generate_stepwise(lp[two][:, -24:], 8))
    flips_l, read_l, d_l = tie_aware(
        "llama3 stepwise vs generate", lstep["tokens"], lref["tokens"],
        lref["logits"].float().cpu().numpy(),
        lstep["logits"].float().cpu().numpy())
    print(f"[5] llama3-8b (4 layers) generate B=8 max_new=16: "
          f"{t_llama:.2f} s; stepwise tie-aware equal ({flips_l} flips, "
          f"logits {d_l:.4f} apart, reading {read_l:.3f})")
    report["cloud"] = {"generate_s": t_llama, "stepwise_tie_flips": flips_l,
                       "stepwise_tie_reading": read_l}
    report["launches_by_path"] = path_launches

    # ---- 6. the tie budget between sound and wrong paths ---------------
    @contextlib.contextmanager
    def drop_cache_write(n_layers, steps, layers):
        """Drop the K/V/pos cache writes of the decode steps ``steps`` (None:
        every step) in ``layers``: those tokens are then invisible there."""
        orig = attention._write_slot
        calls = [0]

        def write(t, b, slot, val, keep):
            n = calls[0]
            calls[0] += 1
            if ((steps is None or n // (3 * n_layers) in steps)
                    and (n // 3) % n_layers in layers):
                return
            orig(t, b, slot, val, keep)

        attention._write_slot = write
        try:
            yield
        finally:
            attention._write_slot = orig

    @contextlib.contextmanager
    def bf16_probabilities():
        """Decode attention with the softmax weights rounded to bf16 before
        the PV product (the JAX model path's rounding site), f32 otherwise."""
        orig = attention.decode_attention

        def attend(q, k, v, pos, index, *, window=None):
            s = torch.einsum("bkgd,btkd->bkgt", q.float(),
                             k.float()) * q.shape[-1] ** -0.5
            valid = (pos >= 0) & (pos <= index[:, None])
            if window is not None:
                valid = valid & (index[:, None] - pos < window)
            s = s.masked_fill(~valid[:, None, None, :], dref.NEG_INF)
            p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
            return torch.einsum("bkgt,btkd->bkgd", p, v.float()).to(q.dtype)

        attention.decode_attention = attend
        try:
            yield
        finally:
            attention.decode_attention = orig

    def readings(engine, n_layers, plen, steps, seeds):
        sound, ref, pr = [], None, None
        for s in seeds:
            r = np.random.default_rng(1000 + s)
            pr = r.integers(1, V, (2, plen)).astype(np.int32)
            ref = engine.generate(pr, steps)
            st = engine.generate_stepwise(pr, steps)
            sound.append(tie_reading(
                st["tokens"], ref["tokens"],
                ref["logits"].float().cpu().numpy(),
                st["logits"].float().cpu().numpy()))
        wrong = {}
        rl = ref["logits"].float().cpu().numpy()
        every = range(n_layers)
        for name, ctx in (
                ("no decode step writes its K/V",
                 drop_cache_write(n_layers, None, every)),
                ("one step's K/V write dropped, all layers",
                 drop_cache_write(n_layers, (2,), every)),
                ("one step's K/V write dropped, layer 0",
                 drop_cache_write(n_layers, (2,), (0,))),
                ("bf16 p before PV", bf16_probabilities())):
            with ctx:
                mut = engine.generate(pr, steps)
            wrong[name] = tie_reading(mut["tokens"], ref["tokens"], rl,
                                      mut["logits"].float().cpu().numpy())
        return sound, wrong

    calib = {}
    for label, engine, n_layers, plen, steps in (
            ("smollm-135m", probe, cfg.num_layers, 40, 24),
            ("llama3-8b 4 layers", cloud, lcfg.num_layers, 40, 16)):
        sound, wrong = readings(engine, n_layers, plen, steps, range(4))
        calib[label] = {"sound": sound, "wrong": wrong}
        print(f"[6] {label}: stepwise vs generate over 4 prompt seeds: "
              "readings " + ", ".join(
                  f"{r:.3f} ({d:.4f} apart, {f} flips)"
                  for f, r, d in sound))
        for name, (f, r, d) in wrong.items():
            print(f"[6] {label}: {name}: reading {r:.3f} ({d:.4f} apart "
                  f"before a flip, {f} flips)")
    report["tie_budget"] = {"atol": TIE_ATOL, "ulps": TIE_ULPS,
                            "readings": calib}
    for label, c in calib.items():
        worst = max(r for _, r, _ in c["sound"])
        check(worst <= 1.0, f"{label}: a sound path reads {worst:.3f} of the "
                            "tie budget")
        bad = c["wrong"]["no decode step writes its K/V"][1]
        check(bad > 1.0, f"{label}: a decode that never writes its K/V "
                         f"reads only {bad:.3f} of the tie budget: it would "
                         "pass")
    del model, probe, lmodel, cloud

    # ---- 7. Algorithm 1: the gateway at published widths --------------
    tcfgs = tier_configs()
    t0 = time.perf_counter()
    tiers = {}
    for i, (name, tcfg) in enumerate(tcfgs.items()):
        tiers[name] = (tcfg, init_params(
            tcfg, torch.Generator(device=dev).manual_seed(SEED + 10 + i),
            device=dev))
    # the classifier and the engines take their default device (the card)
    scfg = safety_lib.classifier_config(vocab_size=512)
    sparams = safety_lib.init_safety(
        scfg, torch.Generator(device=dev).manual_seed(SEED + 20))
    torch.cuda.synchronize()
    weight_gb = {n: sum(p.numel() * p.element_size()
                        for p in m.parameters()) / 1e9
                 for n, (_, m) in tiers.items()}
    print(f"[7] tiers initialised in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{n} {tcfgs[n].name} {tcfgs[n].num_layers} layers "
                      f"{gb:.2f} GB" for n, gb in weight_gb.items()))
    gw, gprobe, gcloud, world = gateway_from_weights(
        **tiers, safety=(scfg, sparams))
    check(gprobe.device.type == "cuda"
          and gw.safety_params.embed.device.type == "cuda",
          "gateway: an engine or the safety classifier is not on the card")
    queries = world.study_workload()
    rp = pad_prompts([q["prompt"] for q in queries], align="right")
    with torch.inference_mode():
        s_study = safety_lib.safety_score(
            sparams, scfg, torch.as_tensor(rp, device=dev)).cpu().numpy()
    gw.router_cfg = dataclasses.replace(gw.router_cfg,
                                        sigma=float(np.median(s_study)))
    rc = gw.router_cfg
    print(f"[7] tau {rc.tau_low:.6f}/{rc.tau_high:.6f} (calibrated), sigma "
          f"{rc.sigma:.6f} (median s of the workload)")

    # wall time per tier: each engine's generate and the safety gate,
    # synchronised, summed over one batch; and each tier's row-5 launches
    tier_s: dict[str, float] = {}
    tier_k5: dict[str, int] = {}

    @contextlib.contextmanager
    def timed_tiers(engines):
        """Time each engine's ``generate`` and the gateway's safety gate
        while inside; the patched names are restored on the way out."""
        def timed(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                n5 = dops.paged_counts.launches
                out = fn(*a, **k)
                torch.cuda.synchronize()
                tier_s[name] = (tier_s.get(name, 0.0)
                                + time.perf_counter() - t)
                tier_k5[name] = (tier_k5.get(name, 0)
                                 + dops.paged_counts.launches - n5)
                return out
            return run

        orig_score = gateway_mod.safety_score
        for eng in engines:
            eng.generate = timed(eng.name, eng.generate)
        gateway_mod.safety_score = timed("safety gate", orig_score)
        try:
            yield
        finally:
            gateway_mod.safety_score = orig_score
            for eng in engines:
                del eng.generate               # back to the class's method

    members = [gprobe] + [m for m in gw.swarm.members if m is not gprobe]
    gw.answer_batch(queries)                     # warm up every tier
    gw.reset_fault_state()
    before = dict(gprobe.counters)
    with timed_tiers(members + [gcloud]):
        t0 = time.perf_counter()
        log = counted("gateway answer_batch", MONO_KERNELS,
                      lambda: gw.answer_batch(queries),
                      forbid=("paged_decode_attention",))
        t_batch = time.perf_counter() - t0
    batch_tiers = dict(tier_s)
    dec = log.decision
    routes = {n: int((dec == c).sum())
              for c, n in enumerate(router.DECISION_NAMES)}
    check(bool(np.isin(dec, range(len(router.DECISION_NAMES))).all()),
          f"gateway: invalid decision codes {np.unique(dec)}")
    check(routes["local"] > 0 and routes["swarm"] > 0
          and routes["cloud"] + routes["cloud_safety"] > 0,
          f"gateway: not every route occurs: {routes}")
    for name, x in (("u", log.u), ("s", log.safety)):
        check(bool(np.isfinite(x).all() and (x >= 0).all()
                   and (x <= 1).all()), f"gateway: {name} outside [0, 1]")
    check(log.answers.shape == (len(queries), gw.max_new),
          f"gateway: answers {log.answers.shape}")
    d_prefill = gprobe.counters["prefill"] - before["prefill"]
    d_decode = gprobe.counters["decode_only"] - before["decode_only"]
    check(d_prefill == 1 and d_decode == 0,
          f"gateway: the probe ran {d_prefill} prefills and {d_decode} "
          "decode-only extensions in one batch (want 1 and 0: the swarm "
          "round reuses the probe's generation)")
    n_grid = path_launches["gateway answer_batch"]["flash_attention"]
    check(n_grid == scfg.num_layers,
          f"gateway: the safety encoder launched {n_grid} times, want "
          f"{scfg.num_layers} (one per layer)")
    print(f"[7] answer_batch on {len(queries)} queries: {t_batch:.3f} s; "
          f"routes {routes}; tiers " + ", ".join(
              f"{n} {t:.3f} s" for n, t in batch_tiers.items()))

    t0 = time.perf_counter()
    edge = counted("run_edge_only", SERVE_KERNELS,
                   lambda: gateway_mod.run_edge_only(
                       queries, gprobe, gw.sim, stop_token=FACT_IS))
    t_edge = time.perf_counter() - t0
    t0 = time.perf_counter()
    cl = counted("run_cloud_only", SERVE_KERNELS,
                 lambda: gateway_mod.run_cloud_only(
                     queries, gcloud, gw.sim, stop_token=FACT_IS))
    t_cloud = time.perf_counter() - t0
    for name, lg in (("edge-only", edge), ("cloud-only", cl)):
        check(bool(np.isfinite(lg.u).all() and np.isfinite(lg.latency).all()
                   and lg.answers.shape == log.answers.shape),
              f"{name}: non-finite or misshapen log")
    print(f"[7] run_edge_only {t_edge:.3f} s, run_cloud_only {t_cloud:.3f} s")
    pm = log.privacy()
    report["gateway"] = {
        "tiers": {n: {"arch": tcfgs[n].name, "layers": tcfgs[n].num_layers,
                      "weights_gb": weight_gb[n]} for n in tcfgs},
        "tau_low": rc.tau_low, "tau_high": rc.tau_high, "sigma": rc.sigma,
        "answer_batch_s": t_batch, "tier_s": batch_tiers,
        "edge_only_s": t_edge, "cloud_only_s": t_cloud, "routes": routes,
        "faults": log.faults, "cloud_usage": log.cloud_usage(),
        "privacy": {k: float(v) for k, v in pm._asdict().items()},
        "latency_sim_mean_s": float(log.latency.mean()),
        "u": [float(x) for x in log.u], "s": [float(x) for x in log.safety]}

    # ---- 7p. the gateway on paged engines -------------------------------
    # the same tiers, weights, classifier and router config, every engine
    # on its own 1024-block pool (the reference CLI's --paged); the same
    # warm-up-then-counted sequence as phase 7, so budgets and simulator
    # draws match
    pgw, pgprobe, pgcloud, _ = gateway_from_weights(
        **tiers, safety=(scfg, sparams), router_cfg=gw.router_cfg,
        engine_kw=dict(paged=True, pool_blocks=1024))
    pmembers = [pgprobe] + [m for m in pgw.swarm.members if m is not pgprobe]
    pool_gb = sum(e.pool.pool_bytes for e in pmembers + [pgcloud]) / 1e9
    check(all(e.paged and e.attn_decode_impl == "kernel"
              for e in pmembers + [pgcloud]), "7p: an engine is not paged")
    p_base = pgprobe.pool.blocks_in_use
    pgw.answer_batch(queries)                    # warm up, as phase 7
    check(pgprobe.pool.blocks_in_use == p_base,
          "7p: the probe's pool kept blocks after a batch")
    pgw.reset_fault_state()
    before_p = dict(pgprobe.counters)
    tier_s.clear()
    tier_k5.clear()
    with timed_tiers(pmembers + [pgcloud]):
        t0 = time.perf_counter()
        plog_gw = counted("paged gateway answer_batch", PAGED_KERNELS,
                          lambda: pgw.answer_batch(queries),
                          forbid=("decode_attention",))
        t_pbatch = time.perf_counter() - t0
    pbatch_tiers, pk5 = dict(tier_s), dict(tier_k5)
    check(pgprobe.pool.blocks_in_use == p_base
          and pgprobe.pool.live_sessions == 0,
          "7p: the probe's pool kept blocks or handles after a batch")
    pdec = plog_gw.decision
    proutes = {n: int((pdec == c).sum())
               for c, n in enumerate(router.DECISION_NAMES)}
    check(np.array_equal(plog_gw.safety, log.safety),
          "7p: s differs from phase 7's")
    du = np.abs(plog_gw.u - log.u)
    check(float(du.max()) <= 1e-2, f"7p: |u_paged - u_mono| reaches "
                                   f"{float(du.max())} > 1e-2")
    near = np.minimum(np.abs(log.u - rc.tau_low), np.abs(log.u - rc.tau_high))
    moved = np.where(pdec != dec)[0]
    check(bool((near[moved] <= 1e-2).all()),
          f"7p: queries {moved.tolist()} routed otherwise than in phase 7 "
          f"at u {(near[moved]).tolist()} from a threshold")
    for eng in pmembers + [pgcloud]:
        if eng.name in pbatch_tiers:
            check(pk5.get(eng.name, 0) > 0,
                  f"7p: {eng.name} decoded without row 5")
    d_pprefill = pgprobe.counters["prefill"] - before_p["prefill"]
    check(d_pprefill == 1, f"7p: the paged probe ran {d_pprefill} prefills")
    # each tier's answers, paged vs monolithic, on the study prompts
    sp = pad_prompts([q["prompt"] for q in queries])
    tier_read, flipped = {}, 0
    for mono_e, pag_e in zip([gprobe] + [m for m in gw.swarm.members
                                         if m is not gprobe] + [gcloud],
                             pmembers + [pgcloud]):
        a = mono_e.generate(sp, gw.max_new)
        b = pag_e.generate(sp, gw.max_new)
        tier_read[pag_e.name] = tie_aware(
            f"7p: {pag_e.name} paged vs monolithic generate", b["tokens"],
            a["tokens"], a["logits"].float().cpu().numpy(),
            b["logits"].float().cpu().numpy())
        flipped += tier_read[pag_e.name][0]
    alike = pdec == dec
    n_ans = int((plog_gw.answers[alike] != log.answers[alike]).any(1).sum())
    check(n_ans == 0 or flipped > 0,
          f"7p: {n_ans} queries routed alike got other answers with no tier "
          "diverging at a tie")
    in_use = {e.name: e.pool.blocks_in_use for e in pmembers + [pgcloud]}
    print(f"[7p] paged gateway ({pool_gb:.2f} GB of pools): answer_batch "
          f"{t_pbatch:.3f} s (monolithic {t_batch:.3f} s); routes {proutes} "
          f"({len(moved)} moved); max |u_paged - u_mono| {du.max():.3e}; s "
          f"identical; {n_ans} routed-alike answers differ ({flipped} tier "
          f"rows diverged at a tie); tiers " + ", ".join(
              f"{n} {t:.3f} s ({pk5.get(n, 0)} row-5 launches)"
              for n, t in pbatch_tiers.items()) + f"; blocks in use {in_use}")
    report["paged_gateway"] = {
        "pool_gb": pool_gb, "answer_batch_s": t_pbatch,
        "mono_answer_batch_s": t_batch, "tier_s": pbatch_tiers,
        "tier_row5_launches": pk5, "routes": proutes,
        "moved": moved.tolist(), "max_du": float(du.max()),
        "routed_alike_answers_differ": n_ans,
        "tier_tie_readings": {k: list(v) for k, v in tier_read.items()},
        "blocks_in_use": in_use}
    del pgw, pgprobe, pgcloud, pmembers

    # ---- 8. the full-sequence forward: kernel vs plain version ---------
    pcfg, pmodel = tiers["probe"]
    ftok = torch.randint(1, pcfg.vocab_size, (8, 256), generator=gen,
                         device=dev, dtype=torch.int32)
    with torch.inference_mode():
        fk, _ = counted("smollm forward", ("flash_attention",),
                        lambda: transformer.forward(pmodel, pcfg,
                                                    {"tokens": ftok}))
        orig = attention.flash_attention
        attention.flash_attention = fref.flash_attention_ref
        try:
            fp, _ = transformer.forward(pmodel, pcfg, {"tokens": ftok})
        finally:
            attention.flash_attention = orig
    check(path_launches["smollm forward"]["flash_attention"]
          == pcfg.num_layers, "forward: not one grid launch per layer")
    fk, fp = fk.float(), fp.float()
    check(bool(torch.isfinite(fk).all()), "forward: non-finite logits")
    f_atol = max(TIE_ATOL, TIE_ULPS * bf16_ulp(float(fp.abs().max())))
    f_diff = float((fk - fp).abs().max())
    f_agree = float((fk.argmax(-1) == fp.argmax(-1)).float().mean())
    check(f_diff <= f_atol, f"forward: kernel and plain logits differ by "
                            f"{f_diff} > {f_atol}")
    print(f"[8] smollm forward B=8 S=256: logits {f_diff:.4f} apart (budget "
          f"{f_atol:.4f}), argmax agreement {f_agree:.4f}")
    report["forward"] = {"max_dlogit": f_diff, "atol": f_atol,
                         "argmax_agreement": f_agree}
    del tiers, gw, gprobe, gcloud, pmodel, sparams, members, eng, mono_e, \
        pag_e, fk, fp, ftok
    gc.collect()
    torch.cuda.empty_cache()

    # ---- T1. training at published width --------------------------------
    t_phase = time.perf_counter()
    held_gb = torch.cuda.memory_allocated() / 1e9   # left by phases 1-8
    # the reference CLI's AdamW (lr 3e-4, warm-up a tenth of the steps),
    # batch 8, seq 128; the loss and no kernel through all 30 steps, then
    # two profiled steps for the device's busy share
    n_train = 30
    train_rep: dict = {}
    for arch, layers in (("smollm-135m", None), ("llama3-8b", 4)):
        tcfg = configs.get_config(arch)
        if layers is not None:
            tcfg = dataclasses.replace(tcfg, num_layers=layers)
        tmodel = init_params(tcfg, torch.Generator(device=dev).manual_seed(
            SEED + 30), device=dev)
        before = [p.detach().to("cpu", copy=True) for p in tmodel.parameters()]
        tstate = opt.init(tmodel)
        step_fn = TR.build_train_step(tcfg, opt.AdamWConfig(
            lr=3e-4, total_steps=n_train, warmup_steps=max(n_train // 10, 1)))
        pipe = SyntheticLMPipeline(8, 128, seed=SEED)
        batches = [device_put_batch(pipe.get_batch(i), dev)
                   for i in range(n_train + 2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s, losses = [], []

        def train_run():
            for i in range(n_train):
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, _, m = step_fn(tmodel, tstate, batches[i])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                losses.append(m["loss"])

        counted(f"train {tcfg.name}", (), train_run, forbid=KERNELS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = torch.stack(losses).tolist()
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        check(bool(np.isfinite(losses).all()) and last < first,
              f"T1 {tcfg.name}: the loss did not fall ({first} -> {last})")
        same = [n for (n, p), b in zip(tmodel.named_parameters(), before)
                if torch.equal(p.detach().cpu(), b)]
        check(not same, f"T1 {tcfg.name}: parameters unchanged: {same[:5]}")
        del before
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in (n_train, n_train + 1):
                step_fn(tmodel, tstate, batches[i])
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in ka)
        top = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in ka), reverse=True)[:6]
        ms = float(np.median(step_s[3:])) * 1e3
        # N: every weight in a product, the LM head included (the embedding
        # lookup is not a product; a tied head is the embedding table)
        n_prod = sum(p.numel() for n, p in tmodel.named_parameters()
                     if p.ndim >= 2 and n != "embed")
        if tcfg.tie_embeddings:
            n_prod += tmodel.embed.numel()
        tokens = 8 * 128
        tflops = 6 * n_prod * tokens / (ms / 1e3) / 1e12
        busy = dev_us / 2 / 1e3 / ms if dev_us > 0 else None
        print(f"[T1] train {tcfg.name} ({tcfg.num_layers} layers, "
              f"{n_prod / 1e9:.3f} B weights in products): loss "
              f"{first:.4f} -> {last:.4f} (mean of the first/last 5 of "
              f"{n_train}), {ms:.2f} ms/step, {tokens / ms * 1e3:.0f} "
              f"tokens/s, model {tflops:.2f} TFLOP/s ({tflops / 989 * 100:.2f}"
              f"% of 989), peak {peak_gb:.2f} GB ({held_gb:.2f} GB held "
              f"before the phase), busy share "
              f"{'not measured' if busy is None else f'{busy:.3f}'}")
        for us, key, n in top:
            print(f"[T1]   2 steps: {us / 1e3:9.3f} ms in {n:5d} x "
                  f"{key[:70]}")
        train_rep[tcfg.name] = {
            "layers": tcfg.num_layers, "weights_in_products": n_prod,
            "losses": losses, "ms_per_step": ms,
            "tokens_per_s": tokens / ms * 1e3, "model_tflops": tflops,
            "peak_gb": peak_gb, "step_device_ms": dev_us / 2 / 1e3,
            "busy_share": busy,
            "profile_top_2steps": [(us / 1e3, key, n) for us, key, n in top]}
        del tmodel, tstate, batches, step_fn, prof
        torch.cuda.empty_cache()
    t_t1 = time.perf_counter() - t_phase
    print(f"[T1] phase {t_t1:.1f} s")
    report["train"] = dict(train_rep, phase_s=t_t1, held_gb=held_gb)

    # ---- T2. checkpoint and restart through the CLI ---------------------
    t_phase = time.perf_counter()
    ck_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck_root, ignore_errors=True)
    ck_root.mkdir(parents=True)
    try:
        c135 = configs.get_config("smollm-135m")
        m135 = init_params(c135, torch.Generator(device=dev).manual_seed(
            SEED), device=dev)
        tree = {"params": m135, "opt": opt.init(m135)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = Path(ck.save(str(ck_root / "timing"), 1, tree))
        t_save = time.perf_counter() - t0
        ck_bytes = sum(f.stat().st_size for f in path.iterdir())
        t0 = time.perf_counter()
        ck.restore(str(ck_root / "timing"), 1, tree)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        del m135, tree
        torch.cuda.empty_cache()

        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cli = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "smollm-135m", "--steps", "40", "--batch", "8", "--seq",
               "128", "--ckpt-every", "20", "--ckpt-dir"]
        d1, d2 = str(ck_root / "straight"), str(ck_root / "restarted")
        t0 = time.perf_counter()
        r1 = subprocess.run(cli + [d1], env=env, capture_output=True,
                            text=True, timeout=400)
        t_straight = time.perf_counter() - t0
        check(r1.returncode == 0, f"T2: the straight run failed: "
                                  f"{r1.stderr[-2000:]}")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cli + [d2], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        try:
            for line in proc.stdout:
                if line.startswith("[train] checkpoint @ 20"):
                    break
        finally:
            proc.kill()
            proc.wait(timeout=60)
            proc.stdout.close()
        check(ck.latest_step(d2) == 20, f"T2: the killed run left "
                                        f"checkpoint {ck.latest_step(d2)}")
        r2 = subprocess.run(cli + [d2, "--resume"], env=env,
                            capture_output=True, text=True, timeout=400)
        t_restart = time.perf_counter() - t0
        check(r2.returncode == 0 and "[train] resumed from step 20"
              in r2.stdout, f"T2: the resumed run failed: "
                            f"{r2.stdout[-1000:]} {r2.stderr[-2000:]}")
        a, _ = ck.load_leaves(d1, 40)
        b, _ = ck.load_leaves(d2, 40)
        check(sorted(a) == sorted(b), "T2: the checkpoints hold other leaves")

        def bits(x):
            if isinstance(x, int):
                return torch.tensor([x])
            return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                           8: torch.int64}[x.element_size()])

        differ = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        check(not differ, f"T2: step_40 of the restarted run differs from "
                          f"the straight run's in {len(differ)} leaves: "
                          f"{differ[:5]}")
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)
    print(f"[T2] checkpoint of smollm-135m + AdamW state: {ck_bytes / 1e9:.3f}"
          f" GB, save {t_save:.2f} s, restore {t_restore:.2f} s; CLI 40 "
          f"steps straight {t_straight:.1f} s, killed at step 20 and resumed "
          f"{t_restart:.1f} s: step_40 bitwise equal in all {len(a)} leaves")
    t_t2 = time.perf_counter() - t_phase
    print(f"[T2] phase {t_t2:.1f} s")
    report["checkpoint"] = {"phase_s": t_t2, "bytes": ck_bytes,
                            "save_s": t_save,
                            "restore_s": t_restore, "leaves": len(a),
                            "straight_s": t_straight,
                            "restarted_s": t_restart}

    # ---- T3. the trained gateway (the paper's study) ---------------------
    t_phase = time.perf_counter()
    train_s, tier_losses = {}, {}

    def timed_train(fn, key):
        def run(*a, **k):
            rec = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, losses=rec, **k)
            torch.cuda.synchronize()
            name = key(a)
            train_s[name] = time.perf_counter() - t
            tier_losses[name] = torch.stack(rec).tolist()
            return out
        return run

    orig_lm, orig_safety = serve_mod.train_lm, serve_mod.train_safety
    serve_mod.train_lm = timed_train(orig_lm, lambda a: a[0])
    serve_mod.train_safety = timed_train(orig_safety, lambda a: "safety")
    try:
        t0 = time.perf_counter()
        tgw, tprobe, tcloud, tworld = serve_mod.build_gateway(train_steps=400)
        t_build = time.perf_counter() - t0
    finally:
        serve_mod.train_lm, serve_mod.train_safety = orig_lm, orig_safety
    for name, ls in tier_losses.items():
        check(bool(np.isfinite(ls).all()) and ls[-1] < ls[0],
              f"T3: {name} loss {ls[0]} -> {ls[-1]}")
    print(f"[T3] build_gateway(train_steps=400): {t_build:.1f} s; "
          + ", ".join(f"{n} {len(ls)} steps {train_s[n]:.1f} s loss "
                      f"{ls[0]:.3f} -> {ls[-1]:.3f}"
                      for n, ls in tier_losses.items()))
    tq = tworld.study_workload()
    t0 = time.perf_counter()
    tlog = counted("trained gateway answer_batch", MONO_KERNELS,
                   lambda: tgw.answer_batch(tq),
                   forbid=("paged_decode_attention",))
    t_tbatch = time.perf_counter() - t0
    tdec = tlog.decision
    troutes = {n: int((tdec == c).sum())
               for c, n in enumerate(router.DECISION_NAMES)}
    check(troutes["local"] > 0 and troutes["swarm"] > 0
          and troutes["cloud"] + troutes["cloud_safety"] > 0,
          f"T3: not every route occurs: {troutes}")
    u_span = float(tlog.u.max() - tlog.u.min())
    check(u_span > 100 * 1e-4, f"T3: u spans only {u_span}")
    tedge = counted("trained run_edge_only", SERVE_KERNELS,
                    lambda: gateway_mod.run_edge_only(
                        tq, tprobe, tgw.sim, stop_token=FACT_IS))
    tcl = counted("trained run_cloud_only", SERVE_KERNELS,
                  lambda: gateway_mod.run_cloud_only(
                      tq, tcloud, tgw.sim, stop_token=FACT_IS))
    trc = tgw.router_cfg
    print(f"[T3] tau {trc.tau_low:.4f}/{trc.tau_high:.4f} (calibrated), u "
          f"spans {u_span:.4f}; answer_batch {t_tbatch:.3f} s; routes "
          f"{troutes}")
    print(serve_mod.tables(tedge, tcl, tlog))

    # the same weights on paged engines (the reference CLI's --paged)
    eng = {e.name: e for e in tgw.swarm.members}
    ptgw, ptprobe, ptcloud, _ = gateway_from_weights(
        probe=(tprobe.cfg, tprobe.params),
        edge_1b=(eng["edge-1b"].cfg, eng["edge-1b"].params),
        edge_qwen=(eng["edge-qwen"].cfg, eng["edge-qwen"].params),
        cloud=(tcloud.cfg, tcloud.params),
        safety=(tgw.safety_cfg, tgw.safety_params), router_cfg=trc,
        world=tworld, engine_kw=dict(paged=True, pool_blocks=1024))
    t0 = time.perf_counter()
    ptlog = counted("trained paged gateway answer_batch", PAGED_KERNELS,
                    lambda: ptgw.answer_batch(tq),
                    forbid=("decode_attention",))
    t_ptbatch = time.perf_counter() - t0
    check(np.array_equal(ptlog.safety, tlog.safety),
          "T3: the paged gateway's s differs")
    tdu = float(np.abs(ptlog.u - tlog.u).max())
    check(tdu <= 1e-2, f"T3: |u_paged - u_mono| reaches {tdu} > 1e-2")
    ptedge = gateway_mod.run_edge_only(tq, ptprobe, ptgw.sim,
                                       stop_token=FACT_IS)
    ptcl = gateway_mod.run_cloud_only(tq, ptcloud, ptgw.sim,
                                      stop_token=FACT_IS)
    tmoved = int((ptlog.decision != tdec).sum())
    print(f"[T3] paged: answer_batch {t_ptbatch:.3f} s (monolithic "
          f"{t_tbatch:.3f} s); max |u_paged - u_mono| {tdu:.3e}; s identical;"
          f" {tmoved} decisions differ")
    print(serve_mod.tables(ptedge, ptcl, ptlog))

    def table_rows(edge_, cl_, lg):
        out = {}
        for name, x in (("edge_only", edge_), ("cloud_only", cl_),
                        ("swarm_llm", lg)):
            out[name] = {"latency_mean_s": float(x.latency.mean()),
                         "latency_p95_s": float(np.percentile(x.latency, 95)),
                         "cloud_usage": x.cloud_usage(),
                         "accuracy": x.accuracy(),
                         "accuracy_easy": x.accuracy("easy"),
                         "accuracy_hard": x.accuracy("hard")}
        out["privacy"] = {k: float(v) for k, v in lg.privacy()._asdict(
            ).items()}
        return out

    report["trained_gateway"] = {
        "build_s": t_build, "train_s": train_s,
        "first_last_loss": {n: (ls[0], ls[-1])
                            for n, ls in tier_losses.items()},
        "tau_low": trc.tau_low, "tau_high": trc.tau_high,
        "sigma": trc.sigma, "u_span": u_span, "routes": troutes,
        "answer_batch_s": t_tbatch, "paged_answer_batch_s": t_ptbatch,
        "paged_max_du": tdu, "paged_moved": tmoved,
        "tables": table_rows(tedge, tcl, tlog),
        "paged_tables": table_rows(ptedge, ptcl, ptlog),
        "u": [float(x) for x in tlog.u]}
    del tgw, tprobe, tcloud, ptgw, ptprobe, ptcloud, eng
    t_t3 = time.perf_counter() - t_phase
    print(f"[T3] phase {t_t3:.1f} s")
    report["trained_gateway"]["phase_s"] = t_t3

    # ---- 9. kernels line and result ------------------------------------
    src = {"flash_attention_positions": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:128"),
           "decode_attention": (
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:271"),
           "swarm_uncertainty": (
               "src/repro_torch/csrc/swarm_uncertainty.cu",
               "src/repro/kernels/swarm_uncertainty/kernel.py:96"),
           "flash_attention": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:169"),
           "paged_decode_attention": (
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:165")}
    kernels = []
    for name in KERNELS:
        first = next(c for c in checks if c["name"] == name and c["main"])
        main_path = ("paged gateway answer_batch"
                     if name == "paged_decode_attention"
                     else "gateway answer_batch")
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1],
            "launches": path_launches[main_path][name],
            "launches_by_path": {p: n[name]
                                 for p, n in path_launches.items()},
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]})
    report["kernels"] = kernels
    report["wall_s"] = time.perf_counter() - T_START
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"[9] chip_smoke took {report['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
