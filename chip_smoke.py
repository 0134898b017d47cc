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
4g. every ``generate`` on the card is one replay of a captured CUDA graph
   holding prefill and decode, and every other decode dispatch one replay
   of a decode graph (the engines' default, so phases 4-8 and T3 serve
   through graphs and their launch gates read the counts each replay
   credits): the graph route held BITWISE to the eager route (an engine
   with ``_graphs = None``) on the same weights — tokens, logits, Eq. 2-3
   means and the returned state (a monolithic cache too) of phase 4's
   ``generate`` and its ``_extend``, a sampled ``generate`` (seed 0), the
   paged kernel and gather routes (their served pool blocks too),
   ``llama3-8b`` at 4 layers, ``serve()``; then decode ms/step and busy
   share (``torch.profiler``) of eager and graph (one turn each, to keep
   the script inside its time), capture seconds, graphs held, the memory
   captures keep
   and the arena's copy-in/out bytes;
F1. whole generation in one device call on the probe (30 layers, phase
   4's prompts): cold and warm ``generate`` (held bitwise to the eager
   route in 4g), monolithic and paged on the kernel and gather routes,
   greedy and sampled, each, profiled, one ``cudaGraphLaunch`` with no
   kernel launched from the host inside the dispatch but staging ones
   (copies, the replay's generator fills); 150-column prompts in the 256 bucket
   replay the 200-column graph; ms per ``generate`` against the split route
   (eager prefill, then a decode replay) in turns, the eager prefill's
   share, a new key's capture seconds, graphs held, the bytes captures
   keep and the cache bytes a dispatch copies;
Q1. quantized serving weights: the reference's budget against the bf16
   engine (2 * max(0.02, 0.01), tie-aware) on its smoke configs
   (``llama3-8b``, ``deepseek-moe-16b``, int8 pool, int8 and fp8
   weights); at published widths the probe and ``llama3-8b`` (4 layers)
   with ``weight_quant`` int8 and fp8, monolithic and paged (int8 pool):
   each quantized engine tie-aware equal to an engine over its
   dequantized weights, its distance to the bf16 engine reported (the
   noise of full-width random weights reads past the smoke budget), the
   graph route bitwise the eager route, weight bytes on the card, decode
   ms/step and busy share beside the bf16 engine's and the bytes a step
   reads; ``deepseek-moe-16b`` (2 layers, int8) gather decode against
   dispatch decode within 0.02; the dequantization bitwise
   ``(q.float() * scale).to(bf16)``;
D1. serving on a (data, model) mesh: on the (1, 1) NCCL mesh (a world of
   one over a ``HashStore``) the probe (30 layers, phase 4's prompts,
   ``max_new=32``) and ``llama3-8b`` (4 layers) on phases 4-5's weights,
   ``generate`` bitwise the single-device engine's, one graph launch per
   ``generate``, rows 1-3 launched and no plain version, ms per
   ``generate`` beside the single-device engine's; two ranks on the one
   card over gloo (``d1_rank``, spawned after the build): ``llama3-8b`` on
   (data=1, model=2) and the probe on (data=2, model=1), tokens, greedy
   and sampled, tie-aware equal to the single-device engine's (a sampled
   stream in its race's scores), per rank its weight bytes, kernels
   launched, ms per ``generate`` and the collectives' share of host and
   device time; after 7p, phase 7's gateway on the (1, 1) mesh: the same
   decisions, u and answers;
D2. the paged pool, quantized weights and pools, and session checkpoints
   on a mesh: on the (1, 1) NCCL mesh the probe (30 layers, 16 tokens)
   paged and ``llama3-8b`` (4 layers) with int8 weights and an int8 pool,
   each ``generate`` bitwise its single-device engine's with one graph
   launch (``mesh11_generate``); two gloo ranks on the card
   (``D2_JOBS``): the probe paged on (data=2, model=1), ``llama3-8b``
   paged with an int8 pool on (1, 2), tie-aware equal to one device, row 5
   launched on each rank's local pool (its share of the blocks, its KV
   heads), each session checkpointed on the mesh and restored on one
   device, its extension tie-aware equal to the uninterrupted one; after
   7p, phase 7p's paged gateway on the (1, 1) mesh: the same decisions, u
   and answers;
D3. the recurrent mixers and MoE expert parallelism on a mesh: beside
   R1-M2, on a (1, 1) NCCL mesh of its own, each phase's served bf16
   engine (``recurrentgemma-2b`` R1's 5 layers, monolithic and paged;
   ``mamba2-780m`` R2's 4; ``deepseek-moe-16b`` M1's 3, the dense layer
   and 2 MoE; ``llama4-scout-17b-a16e`` M2's 2) against the same weights
   on the mesh, each ``generate`` bitwise with one graph launch
   (``d3_mesh11``); after D2, the two gloo ranks' D3 jobs (``D3_JOBS``,
   spawned with D1's): f32 copies on (data=1, model=2) of
   ``recurrentgemma-2b`` (W 1280 per rank, attention placement (b)),
   ``mamba2-780m`` (24 of 48 SSD heads per rank) and ``deepseek-moe-16b``
   paged (32 of 64 experts per rank), B=8, 16 tokens, tie-aware equal to
   one device, row 2 on a rank's own cache and row 5 on its own pool held
   to their plain versions, the deepseek session checkpointed on the
   mesh and restored on one device; per rank ms per ``generate``, weight
   and state bytes, the collectives' count, bytes and device share
   (``phase_d3``);
4f. ``serve()`` under a ``FaultPlan`` at the probe's full width on a paged
   probe: two famine rounds, a forced eviction of a warm handle (cold
   re-prefill from ``cold_prompt``), two slot failures (requeue) and a
   10 s decode straggle on a 1 ms/step clock that expires the request
   with a deadline: every request retires, the expired one shed, the
   others tie-aware equal to phase 4's ``generate`` (the evicted one to a
   cold ``generate`` of its conversation), the counters as injected;
6. the tie budget: stepwise-vs-generate readings over 2 prompt seeds
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
   the wall time per batch and per tier, the graph captures the counted
   batch paid and a second batch's time, the first batch's time and
   captures, the graphs held; then (7p) the same gateway on
   paged engines (``engine_kw=dict(paged=True, pool_blocks=1024)``, as the
   reference CLI's ``--paged``): the same ``s``, ``u`` within 1e-2 and
   every route that differs from phase 7's at a ``u`` within 1e-2 of a
   threshold, every tier decoding through row 5 and never through row 2,
   the probe's pool back at its blocks in use after each batch, 21 more
   batches timed with the captures they paid;
8. ``transformer.forward`` of ``smollm-135m`` at full width (B=8, S=256)
   against the same forward with the grid-offset op's plain version
   swapped in, within the tie budget;
R1. ``recurrentgemma-2b`` at published widths, cut to 5 of its 26 layers
   to keep the script inside its time (RG-LRU +
   windowed attention, head_dim 256, 10 query heads on 1 KV head, window 2048,
   vocabulary 256000), random weights (every matrix but the
   embedding and the convs scaled by 6, so the state and the K/V move the
   logits): ``generate`` on 8 prompts of
   24-200 tokens (bucket 256, ``max_new=32``) on a monolithic cache with
   prefill time, decode ms/step and busy share; the graph route bitwise
   the eager loop (the arena carries the recurrent states); rows 1-3
   launched and no plain version run.  bf16 noise alone (the same
   prompts at batch 1 against batch 8) moves these models' logits past
   the tie budget, so the contracts are held on an f32 copy of the same
   weights: ``generate_stepwise`` and ``serve()`` tie-aware equal to
   ``generate``, and a decode that never writes its K/V must read outside
   the budget; the bf16 readings are printed beside that noise floor (the
   bf16 stepwise on the two shortest prompts, for time; the f32 copies run
   the eager route, which the bf16 engines hold bitwise to the graph
   route; an f32 copy of 3 layers (R2: 2), the first to hold a
   local-attention layer, runs the graph route, cold and warm
   ``generate`` and an extension, monolithic and paged, bitwise the eager
   route).
   Then two ~2300-token prompts whose rings wrap (bf16 served and timed;
   f32 monolithic against ring tables, tie-aware);
R1p. the same weights on a paged pool (blocks of 64, ring tables for the
   local layers, 40 state rows): bf16 ``generate`` (row 5 launched, row 2
   not) and the graph route bitwise with the pool; in f32, ``generate``
   (tie-aware, u within 1e-2), a 200-token prompt absorbed and fanned out
   to 16 sessions (16 state rows copied, KV blocks shared) continued with
   their own spans, ``serve()`` of 16 requests on the handle; an int8
   pool; the pool back at 0 blocks and 0 rows after every path;
R2. ``mamba2-780m`` at published widths, cut to 4 of its 48 SSD layers
   to keep the script inside its time (vocabulary 50280): the same paths
   as R1 and R1p, row 3 launched and no attention
   kernel, a decode that drops the SSD state outside the f32 budget; then
   a swarm round on the study workload's prompts, a
   ``smollm-135m`` probe whose answer is precomputed (no dispatch) beside
   the ``mamba2-780m`` peer (the reference's ``TestSwarmStateReuse``);
M0. the MoE family's shapes (``deepseek-moe-16b``: MHA, 16 heads of
   128, G=1, vocabulary 102400; ``llama4-scout-17b-a16e``: 40 query heads
   on 8 KV heads, G=5, vocabulary 202048): rows 1, 2, 3 and 5 at B=8, an
   S=256 prefill (56 padding columns), decode at positions 256-287 of 320
   slots and a paged table of 5 blocks under 32 delta rows, each within
   2e-2 of its plain version and timed against its bound and SDPA; row 4
   through ``forward`` at deepseek's width (2 layers), f32 held to the
   plain op swapped in, bf16 reported; one full-width MoE layer of each
   config on the card against the port's CPU path in f32 (prefill S=16,
   decode by dispatch and by gather, 1e-4 relative), then in bf16 the
   per-layer ms of the prefill dispatch (TFLOP/s over the dispatch's E*C
   rows and over the B*k real rows) and of decode, dispatch and gather,
   beside the bytes of the experts each reads;
M1. ``deepseek-moe-16b`` at published widths, cut to 3 of its 28 layers
   (the dense one and 2 MoE layers) to keep the script inside its time
   (random weights from a ``torch.Generator`` seed), phase 4's
   8 prompts (bucket 256, ``max_new=32``), through R1's paths (monolithic
   and on a 128-block pool: bf16 served and timed, the graph route bitwise
   the eager loop, rows 1-3 or 1, 3, 5 launched and no plain version);
   the contracts on an f32 copy of the dense layer and the 2 MoE layers
   (~6.5 GB; all 28 in f32 are ~66 GB): ``generate_stepwise``,
   ``serve()``, paged, fan-out and serve-on-a-handle tie-aware, bucket
   padding (256 more inert columns) neutral, and a router that takes the
   k lowest experts must read outside the budget; bf16 readings beside
   their noise floor;
M2. ``llama4-scout-17b-a16e`` at published widths cut to 2 layers (~10.4
   GB, to keep the script inside its time; all 48 are ~215 GB), the same
   paths with the contracts on an f32 copy of both layers, a combine that drops the shared expert outside the
   budget, ``moe_decode_impl="gather"`` tie-aware equal to the dispatch
   (f32; bf16 read and timed), and a swarm round on the 50 study prompts
   with the MoE peer beside a precomputed probe, timed;
M3. 6 AdamW steps of ``deepseek-moe-16b`` at published widths cut to 2
   layers (the dense layer and one MoE layer), B=4, S=128: the loss falls,
   ``moe_aux`` finite and positive, every parameter moves, no kernel
   launched; ms per step;
X0. the last three architectures' shapes: rows 1, 2, 3 and 5 at
   ``command-r-plus-104b``'s (96 query heads on 8 KV heads, G=12, head_dim
   128, vocabulary 256000; B=8, an S=256 prefill with 56 padding columns,
   decode at positions 256-287 of 320 slots, a paged table of 5 blocks
   under 32 delta rows), row 4 at ``llava-next``'s forward (B=4, S=1024,
   causal, 32 heads on 8) and at ``hubert-xlarge``'s (B=4, S=1000, 16
   heads of 80, bidirectional) in bf16 and f32, each within 2e-2 of its
   plain version and timed against its bound and SDPA;
C1. ``command-r-plus-104b`` at published widths cut to 2 of 64 layers
   (~19 GB: the embedding and the untied head are 12.6 GB), phase 4's
   prompts through R1's paths (monolithic and on a 128-block pool, the
   graph route bitwise the eager loop, rows 1-3 or 1, 3, 5 launched and
   no plain version), the contracts on an f32 copy of 1 layer (its f32
   embedding and head alone are 25 GB): ``generate_stepwise``,
   ``serve()``, paged, fan-out and serve-on-a-handle tie-aware, and a
   decode that never writes its K/V outside the budget; decode ms/step
   against the byte bound of the weights a step reads;
V1. ``llava-next-mistral-7b`` at published widths, 16 of its 32 layers
   (to keep the script inside its time): its
   token backbone through C1's paths (the contracts on an f32 copy of 4
   layers), then ``forward`` on B=4 batches of 576 patch embeddings ahead
   of 448 text tokens through row 4, within the tie budget of the same
   forward with row 4's plain version swapped in; 6 AdamW steps of the
   model cut to 4 layers on such batches (the loss falls, every parameter
   moves, no kernel launched);
H1. ``hubert-xlarge`` at published widths, all 48 layers: ``forward`` on
   B=4, S=1000 frame embeddings (bidirectional row 4 at D=80) held to the
   plain op in bf16 and in f32; building an ``InferenceEngine`` on it
   raises; 6 AdamW steps at full depth on a B=2, S=1024 batch (the
   embedding table, which frames never read, moves its f32 master by the
   decay alone);
S1. session checkpoints on the probe (``smollm-135m``, 30 layers): for
   paged -> paged, paged -> monolithic, monolithic -> paged and monolithic
   -> monolithic, ``generate`` with ``return_state``, ``checkpoint_session``,
   the source engine continues with a new span and a fresh destination
   engine restores and continues with it: tokens, logits and u bitwise
   (a paged engine beside a monolithic one decodes through the gathered
   view, bitwise the monolithic engine); a sampled session resumes its
   stream; an int8 pool's checkpoint raises ``QuantMismatchError`` on a
   bf16 engine; checkpoint bytes, save and restore seconds;
T1. training at published width: ``training.train.build_train_step`` on
   ``smollm-135m`` (30 layers) and ``llama3-8b`` cut to the cloud tier's 4
   layers (vocabulary 128256), AdamW lr 3e-4, batch 8, seq 128, 10 steps of
   ``SyntheticLMPipeline`` batches: the loss must fall (mean of the last 5
   below the first 5), every parameter must change, and no kernel and no
   plain version may run (training attends through ``chunked_attention``);
   ms per step, tokens/s, model TFLOP/s (6 N tokens / time) beside 989,
   peak memory and the device busy share of a step (``torch.profiler``);
   then 3 more steps with ``remat=False``: ms/step and peak beside the
   remat steps' (every layer recomputed in the backward), and 3 with the
   recompute through ``torch.utils.checkpoint`` (ms/step);
T4. training on a mesh.  After T1, on a (1, 1) NCCL mesh of its own:
   ``llama3-8b`` (4 layers, bf16) cut by ``shard_params(...,
   DEFAULT_RULES)``, ``T4_STEPS`` steps of ``build_train_step(cfg, ocfg,
   mesh)`` on T1's batches from T1's weights bitwise T1's first steps
   (losses, grad norms, every parameter), no collective, no kernel and no
   plain version, ms/step beside T1's.  Before D1's spawn the parent runs
   ``T4_JOBS`` on one device (``t4_reference``); the two ranks run them in
   D1's spawn (``t4_rank``): ``smollm-135m`` whole on (2, 1) (FSDP),
   ``llama3-8b`` 2 layers (TP, the vocabulary-parallel loss) and
   ``deepseek-moe-16b`` 2 layers (EP) on (1, 2) as f32 copies, each held
   to one device per leaf (first-batch gradient norms; ``T4_SAMPLES``
   sampled elements of the first gradient, the parameters, moments and
   update after the steps) and per step (``phase_t4_ranks``), and
   ``llama3-8b`` bf16 on (1, 2) within the tie
   budget; ms/step, collectives, host and device share, peak GB and
   optimizer bytes a rank against one device;
T2. checkpoint and restart through the CLI: ``launch.train.main(["--arch",
   "smollm-135m", "--steps", "6", "--batch", "8", "--seq", "128",
   "--ckpt-every", "3", ...])`` run to its end in this process, the same
   run as ``python -m repro_torch.launch.train`` in a process of its own
   killed once it prints ``[train] checkpoint @ 3``, and restarted with
   ``--resume`` in this process: the two ``step_6`` checkpoints must hold
   bitwise-equal parameters and optimizer state; save and restore seconds
   and bytes of one checkpoint (6 steps and one interpreter start, to keep
   the script inside its time);
T3. the trained gateway, the paper's study: ``launch.serve.build_gateway(
   train_steps=200)`` (the reference CLI's default is 400; cut for the
   script's time) trains the four smoke
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
serves them, and (R0) at the recurrent families' shapes before R1-R2
serve them: rows 1 and 2 at head_dim 256 with 10 query heads on 1 KV head
(an S=256 prefill, an S=4096 prefill of 2300 real tokens past the 2048
window, a 2048-slot ring decode before and after it wraps), row 5 through
ring tables with bf16 and int8 pools, row 3 at V=256000 and V=50280.

Every path of phases 4-8 (4g's bitwise pairs aside) runs with the
kernels' launch counts set to 0 just before it and read just after: each
kernel the path runs must have launched, and no plain version may have
run; a replayed graph credits the launches its capture recorded, so a
graphed path counts what the eager loop counts.  The ``kernels`` line
gives the counts of the main path's runs — rows 1-4 from one gateway
``answer_batch``, row 5 from one paged gateway ``answer_batch`` (7p) —
with every path's counts beside them; its times and bounds are those of
phase 3's case at the probe tier's gateway shape (rows 1-3 and 5) and at
the safety encoder's (row 4), and its error the largest over all cases.

Without a CUDA device, or without the repository's sources beside this
file, it exits nonzero and prints no result.  Details of the run go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

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
# T3's training steps per tier unit (the reference CLI's default is 400;
# cut to 300, then 250 with D2, then 200 with remat honoured, to keep the
# script inside its time; at 200 the trained gateway routed 3 of the 50
# queries locally on the card, and its check needs at least one)
T3_STEPS = 200
T4_STEPS = 3                # T4's (1, 1) steps, T1's first ones
T2_STEPS = 6                # the CLI runs of T2, killed at half
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


def tie_reading(out_tokens, ref_tokens, ref_logits, out_logits=None,
                atol=None, noise=None):
    """Compare two greedy runs tie-aware (tests/test_continuation.py's rule,
    with the flip's own logits held too): tokens agree up to the first
    mismatch, the logits up to and at it differ by at most atol (those at
    it come from the same tokens in both runs), and at it the reference's
    top-2 logit gap is at most 2 * atol (atol per row as TIE_ATOL above
    says, or the ``atol`` given).

    A sampled run passes its race's log-noise ``noise`` (B, steps, V)
    (``race_noise``): the gap at a flip is then that of the race's scores,
    logits minus log-noise.

    Returns (rows that diverged, reading, largest logit difference up to a
    flip): the reading is, over rows, the largest ratio of the least atol
    that passes the row to the row's atol.  The runs agree when it is <= 1."""
    import numpy as np
    flips, reading, dmax = 0, 0.0, 0.0
    fixed = atol
    for b in range(ref_tokens.shape[0]):
        atol = fixed if fixed is not None else max(TIE_ATOL, TIE_ULPS * bf16_ulp(
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
            top2 = np.sort(ref_logits[b, m] if noise is None
                           else ref_logits[b, m] - noise[b, m])[-2:]
            need = max(need, float(top2[1] - top2[0]) / 2)
            flips += 1
        reading = max(reading, need / atol)
    return flips, reading, dmax


def race_noise(seed: int, B: int, n: int, V: int, device):
    """The log-noise (B, n, V) of a sampled ``generate`` of seed ``seed``
    over a batch of B: the engine draws one (B, V) exponential per decode
    step from a generator of that seed on ``device`` and emits the argmax of
    logits minus log-noise; token 0 is the prefill's argmax (no noise) and
    token t >= 1 came from draw t - 1."""
    import numpy as np
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    out = np.zeros((B, n, V), np.float32)
    for t in range(1, n):
        out[:, t] = torch.empty((B, V), device=device).exponential_(
            1, generator=g).log().cpu().numpy()
    return out


def tie_aware(label, *args, **kw):
    flips, reading, dmax = tie_reading(*args, **kw)
    check(reading <= 1.0, f"{label}: not tie-aware equal (reading "
                          f"{reading:.3f} of the budget, logits differ by "
                          f"{dmax} before a flip, {flips} rows flipped)")
    return flips, reading, dmax


def runtime_calls(prof, span_name: str) -> dict:
    """The CUDA runtime calls a profile holds inside the ranges named
    ``span_name`` (``record_function``), and in the whole profile: graph
    launches, kernel launches with their kernels' names, and copies."""
    launch = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cuLaunchKernelEx")
    import torch
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    # the range's CPU event (a device-side annotation of the same name is
    # not counted)
    spans = [(e.time_range.start, e.time_range.end) for e in evs
             if e.name == span_name]

    def inside(e):
        return any(a <= e.time_range.start and e.time_range.end <= b
                   for a, b in spans)
    out = {"spans": len(spans)}
    for where, keep in (("in", inside), ("all", lambda e: True)):
        sel = [e for e in evs if keep(e)]
        out[f"graph_launches_{where}"] = sum(e.name == "cudaGraphLaunch"
                                             for e in sel)
        ks = [e for e in sel if e.name in launch]
        out[f"kernel_launches_{where}"] = len(ks)
        out[f"kernels_{where}"] = sorted({k.name for e in ks
                                          for k in e.kernels})
        out[f"memcpy_{where}"] = sum(e.name.startswith("cudaMemcpy")
                                     for e in sel)
    return out


def staging_kernel(name: str) -> bool:
    """A kernel that stages a replay: a copy into staging buffers or an
    arena (``_foreach_copy_``), or the fill of a graph's generator seed and
    offset that ``CUDAGraph.replay`` launches itself."""
    n = name.lower()
    return "copy" in n or "multi_tensor_apply" in n or "fill" in n


def phase_f1(c):
    """F1. whole generation in one device call (the port of the
    reference's ``_generate_fused`` / ``_generate_continue`` and their paged
    siblings) on the probe at full width and depth.  Phase 4g held cold and
    warm ``generate`` (and an extension) bitwise to the eager route on
    every route, greedy and sampled; here the same keys are replayed under
    ``torch.profiler`` with the engine's dispatch in a named range: one
    ``cudaGraphLaunch`` per ``generate``, and no kernel launched from the
    host inside the dispatch but staging ones.  Then a prompt set of other
    lengths in the same bucket replays the same graph; ms per ``generate``
    against the split route (eager prefill, then one decode-graph replay) in
    turns, the eager prefill's share, a new key's capture seconds, graphs
    held, the bytes captures keep and the cache bytes a dispatch copies."""
    np, torch = c.np, c.torch
    t_ph = time.perf_counter()
    probe, pr, mn, span = c.probe, c.prompts, c.max_new, c.span
    B = pr.shape[0]
    CPU = torch.profiler.ProfilerActivity.CPU
    CUDA = torch.profiler.ProfilerActivity.CUDA
    rep = {"routes": {}}

    def one_call(label, eng, fn):
        """``fn`` (one generate) profiled with the engine's dispatch in a
        named range: exactly one graph launch, inside it; no kernel
        launched from the host inside the dispatch but staging ones
        (``staging_kernel``), and one replay more."""
        run = eng._graphs.run
        n0 = dict(eng._graphs.stats)

        def traced(*a, **k):
            with torch.profiler.record_function("F1 dispatch"):
                return run(*a, **k)
        eng._graphs.run = traced
        try:
            with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
        finally:
            del eng._graphs.run
        n1 = eng._graphs.stats
        check(n1["replays"] == n0["replays"] + 1
              and n1["captures"] == n0["captures"],
              f"F1 {label}: {n1['replays'] - n0['replays']} replays and "
              f"{n1['captures'] - n0['captures']} captures, want 1 and 0")
        calls = runtime_calls(prof, "F1 dispatch")
        check(calls["spans"] == 1, f"F1 {label}: {calls['spans']} dispatches "
                                   "in one generate")
        check(calls["graph_launches_all"] == 1
              and calls["graph_launches_in"] == 1,
              f"F1 {label}: {calls['graph_launches_all']} graph launches "
              "in one generate, want 1")
        bad = [k for k in calls["kernels_in"] if not staging_kernel(k)]
        check(not bad, f"F1 {label}: kernels launched from the host inside "
                       f"the dispatch: {bad}")
        if not calls["kernels_in"]:
            # the profile linked no kernel names: bound the staging (a
            # sampling graph's replay fills its generator's seed and offset)
            check(calls["kernel_launches_in"] <= 2,
                  f"F1 {label}: {calls['kernel_launches_in']} kernel "
                  "launches inside the dispatch")
        return out, calls

    # profiled at max_new=2 (keys captured first): a graph of the prefill
    # and two steps is one launch as the 32-step one is, and its profile
    # parses in a fraction of the time
    engines = {"mono": probe, **c.paged4g}
    for route, g in engines.items():
        for greedy in ((True, False) if route != "gather" else (True,)):
            label = f"{route} {'greedy' if greedy else 'sampled'}"

            def cold_fn():
                return g.generate(pr, 2, greedy=greedy, seed=0,
                                  return_state=True)

            def warm_fn(st):
                return g.generate(span, 2, greedy=greedy, seed=1, state=st,
                                  return_state=True)
            g.release(warm_fn(cold_fn()["state"])["state"])   # capture
            cold, cc = one_call(f"{label} cold", g, cold_fn)
            warm, cw = one_call(f"{label} warm", g,
                                lambda: warm_fn(cold["state"]))
            g.release(warm["state"])
            rep["routes"][label] = {"cold": cc, "warm": cw}
            print(f"[F1] {label}: cold and warm generate one graph launch "
                  f"each; host kernel launches in the dispatch cold "
                  f"{cc['kernel_launches_in']}, warm "
                  f"{cw['kernel_launches_in']}; in the whole call cold "
                  f"{cc['kernel_launches_all']}, warm "
                  f"{cw['kernel_launches_all']} (a paged continuation's "
                  f"pool resets and copies); memcpy calls cold "
                  f"{cc['memcpy_all']}, warm {cw['memcpy_all']}")
    # a prompt set of other lengths in the same bucket: the same graph
    short = pr[:, -150:]
    check(probe._bucket(short)[0].shape == probe._bucket(pr)[0].shape,
          "F1: not the same bucket")
    probe.generate(pr, mn)                   # the one-shot key exists
    st0 = dict(probe._graphs.stats)
    a = probe.generate(short, mn)
    st1 = dict(probe._graphs.stats)
    b = c.eager_twin(probe).generate(short, mn)
    c.bitwise("F1 150-column prompts in the 256 bucket", a, b)
    check(st1["captures"] == st0["captures"]
          and st1["replays"] == st0["replays"] + 1,
          f"F1: other prompt lengths in one bucket captured a graph "
          f"({st1['captures'] - st0['captures']} captures)")
    print("[F1] 150-column prompts (bucket 256): the 200-column graph "
          "replayed, no capture; bitwise the eager route")

    # ms per generate: the fused call against the split route (eager
    # prefill, then one decode-graph replay), in turns
    pb, s_orig = probe._bucket(pr)
    max_len = probe._cache_len(pb.shape[1], mn)

    @torch.inference_mode()          # as generate runs its dispatches
    def split_route():
        cur, last, cache = probe._prefill_absorb(pb, s_orig, max_len)
        return probe._dispatch("mono", cur, last, cache,
                               probe._full(B, s_orig), mn, True, None)

    @torch.inference_mode()
    def prefill_only():
        return probe._prefill_absorb(pb, s_orig, max_len)

    def wall(fn, n=5):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return float(np.median(ts)) * 1e3
    turns = []
    for name, fn in (("split", split_route), ("fused",
                                            lambda: probe.generate(pr, mn)),
                     ("fused", lambda: probe.generate(pr, mn)),
                     ("split", split_route), ("eager prefill", prefill_only)):
        turns.append((name, wall(fn)))
    ms_f = float(np.mean([t for n, t in turns if n == "fused"]))
    ms_o = float(np.mean([t for n, t in turns if n == "split"]))
    ms_p = [t for n, t in turns if n == "eager prefill"][0]
    # capture seconds of a new key: the same prompts at another max_new
    st0 = dict(probe._graphs.stats)
    t = time.perf_counter()
    probe.generate(pr, mn + 8)
    torch.cuda.synchronize()
    t_new = time.perf_counter() - t
    st1 = dict(probe._graphs.stats)
    cap_s = st1["capture_s"] - st0["capture_s"]
    check(st1["captures"] == st0["captures"] + 1, "F1: a new max_new did "
                                                  "not capture one graph")
    # the cache bytes a dispatch copies: none for a one-shot cold
    # generate, the cache out for a kept one, in and out for a warm one
    io = []
    for fn in (lambda: probe.generate(pr, mn),
               lambda: probe.generate(pr, mn, return_state=True)):
        i0 = probe._graphs.stats["io_bytes"]
        res = fn()
        io.append(probe._graphs.stats["io_bytes"] - i0)
    i0 = probe._graphs.stats["io_bytes"]
    probe.generate(span, mn, state=res["state"])
    io.append(probe._graphs.stats["io_bytes"] - i0)
    check(io[0] == 0, f"F1: a one-shot cold generate copied {io[0]} bytes")
    gs = dict(probe._graphs.stats)
    rep.update(turns_ms=turns, generate_ms=ms_f, split_route_ms=ms_o,
               eager_prefill_ms=ms_p, prefill_share_split=ms_p / ms_o,
               new_key_capture_s=cap_s, new_key_generate_s=t_new,
               io_bytes_cold_one_shot=io[0], io_bytes_cold_kept=io[1],
               io_bytes_warm=io[2], probe_graphs_held=len(probe._graphs),
               probe_stats=gs, phase_s=time.perf_counter() - t_ph)
    print(f"[F1] generate B=8 S=200 (bucket 256) max_new={mn}: fused "
          f"{ms_f:.2f} ms against the split route {ms_o:.2f} ms (eager "
          f"prefill {ms_p:.2f} ms, {ms_p / ms_o:.3f} of it); turns "
          + ", ".join(f"{n} {t:.2f}" for n, t in turns))
    print(f"[F1] a new key: capture {cap_s:.3f} s (its generate "
          f"{t_new:.3f} s); probe graphs held {len(probe._graphs)}, "
          f"{gs['captures']} captures in {gs['capture_s']:.2f} s, "
          f"{gs['pool_bytes'] / 1e6:.1f} MB kept by captures; cache bytes "
          f"copied: one-shot cold {io[0] / 1e6:.1f} MB, kept cold "
          f"{io[1] / 1e6:.1f} MB, warm {io[2] / 1e6:.1f} MB; phase "
          f"{rep['phase_s']:.1f} s")
    c.report["fused"] = rep


# D1's two ranks on the one card: (arch, layers or None for all, model
# parallelism, max_new, engine keywords); each job runs on a (data, model)
# mesh of the two
D1_JOBS = (("llama3-8b", 4, 2, 16, {}), ("smollm-135m", None, 1, 32, {}))
# D2's: the probe paged on (data=2, model=1) (each rank half the pool's
# blocks and rows, a batch of 8 split 4 + 4), llama3-8b paged with an int8
# pool on (1, 2) (each rank 4 of the 8 KV heads); a paged job checkpoints
# its session and extends it D2_EXTEND tokens
D2_POOL = dict(paged=True, pool_blocks=256)
D2_JOBS = (("smollm-135m", None, 1, 16, D2_POOL),
           ("llama3-8b", 4, 2, 16, dict(D2_POOL, cache_quant="int8")))
D2_EXTEND = 8
# D3's, spawned with them: the recurrent and MoE decoders on (1, 2) as f32
# copies (bf16 noise alone reads past the tie budget on these models, as
# R1-M2 found), each with a model option dict: "f32", the seed offset of
# its R1/R2/M1 phase, R1's scale of every matrix but the embedding and the
# convs, "row2" to hold row 2 on the rank's own cache; recurrentgemma-2b
# R1's 5 layers (W 1280 per rank, attention placement (b)), mamba2-780m
# R2's 4 (24 of 48 SSD heads per rank), deepseek-moe-16b 3 layers paged
# (32 of 64 experts per rank), its session checkpointed and extended
D3_JOBS = (("recurrentgemma-2b", 5, 2, 16, {},
            {"f32": True, "seed": 50, "scale": 6.0, "row2": True}),
           ("mamba2-780m", 4, 2, 16, {},
            {"f32": True, "seed": 60, "scale": 6.0}),
           ("deepseek-moe-16b", 3, 2, 16, D2_POOL,
            {"f32": True, "seed": 80}))
# T4's, spawned with them: (arch, layers or None for all, model
# parallelism, steps, dtype) on the two ranks' (2/mp, mp) mesh under the
# training rules: smollm-135m whole on (2, 1) (FSDP: half of every d_model
# dim and 4 of 8 rows a rank), llama3-8b 2 layers on (1, 2) (case (a):
# 16 of 32 heads, 4 of 8 KV heads, half of d_ff and of the vocabulary, the
# vocabulary-parallel loss), deepseek-moe-16b M3's 2 layers on (1, 2) (32
# of 64 experts a rank), each an f32 copy (bf16 noise would hide a wrong
# gradient), then llama3-8b bf16 on (1, 2) (the bf16 cut products
# differentiate); the parent runs each job on one device first
# (``t4_reference``), batch T4_B x T4_S from SyntheticLMPipeline
T4_JOBS = (("smollm-135m", None, 1, 3, "float32"),
           ("llama3-8b", 2, 2, 3, "float32"),
           ("deepseek-moe-16b", 2, 2, 3, "float32"),
           ("llama3-8b", 2, 2, 2, "bfloat16"))
T4_B, T4_S, T4_SEED = 8, 128, 40
# elements of each leaf an f32 T4 job holds to one device, drawn from a
# seed (the whole of a leaf of fewer); a rank holds the ones in its slice
T4_SAMPLES = 8192
D1_COLLECTIVES = ("mesh.all_reduce", "mesh.all_gather")
D1_SAMPLE_SEED = 5          # D1's sampled generate


def collective_share(prof) -> tuple[float, float]:
    """(device ms inside the mesh's collectives, device ms in all) of a
    profile: each kernel and copy counted once, under the CPU op that
    launched it; a collective's range holds its staging copies."""
    import torch
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    coll = sum(e.device_time_total for e in cpu
               if e.name in D1_COLLECTIVES) / 1e3
    return coll, sum(e.self_device_time_total for e in cpu) / 1e3


def job_model(cfg, opt: dict, dev):
    """(config, model) of a rank job, as the main process builds its
    reference: seed ``SEED + opt["seed"]`` on the card, drawn in f32 with
    ``opt["f32"]``, every matrix but the embedding and the convs scaled by
    ``opt["scale"]`` (R1's rule)."""
    import torch
    from repro_torch.models.transformer import init_params
    if opt.get("f32"):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + opt.get("seed", 0)), device=dev)
    if opt.get("scale"):
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.dim() >= 2 and "embed" not in name \
                        and "conv" not in name:
                    p.mul_(opt["scale"])
    return cfg, model


def t4_model(arch: str, layers, dtype: str, dev):
    """(config, model) of a T4 job: the published config cut to ``layers``,
    in ``dtype``, seeded on the card (the parent and both ranks draw the
    same weights)."""
    import torch
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(configs.get_config(arch),
                              dtype=getattr(torch, dtype))
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + T4_SEED), device=dev)


def remat_by_checkpoint(step_fn, model, state, batches) -> list:
    """Seconds of ``step_fn`` on each batch with every layer recomputed
    through ``torch.utils.checkpoint`` instead of ``transformer._Remat``
    (T1's comparison of the two)."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import transformer as T
    from repro_torch.models.common import shallow_copy
    real = T._remat_layer

    def by_checkpoint(layer, x, *args):
        return checkpoint(T._layer, shallow_copy(layer), x, *args,
                          use_reentrant=False, preserve_rng_state=False)

    T._remat_layer = by_checkpoint
    secs = []
    try:
        for b in batches:
            t = time.perf_counter()
            step_fn(model, state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
    finally:
        T._remat_layer = real
    return secs


def t4_coords(cfg) -> dict:
    """{leaf: (its whole shape, (T4_SAMPLES, ndim) coordinates in it)}:
    the elements an f32 T4 job holds to one device, the same in the parent
    and the ranks (drawn leaf by leaf from one seed)."""
    import torch
    from repro_torch.models import transformer as T
    g = torch.Generator().manual_seed(SEED + T4_SEED)
    return {n: (tuple(p.shape), torch.stack([
        torch.randint(d, (T4_SAMPLES,), generator=g) for d in p.shape], 1))
        for n, p in T.Transformer(cfg, device="meta").named_parameters()}


def t4_locate(cut, shape, coords, mesh):
    """(held, index): which of a leaf's sampled whole coordinates lie in
    the rank's slice (``Cut``: a product of per-dim selections, so each dim
    is located on its own through ``Cut.cut`` of the dim's positions) and
    their positions in the rank's leaf (0 where not held)."""
    import torch
    from repro_torch.distributed import sharding as sh
    held = torch.ones(len(coords), dtype=torch.bool)
    index = []
    for d, size in enumerate(shape):
        mine = sh.Cut(tp_axes=cut.tp_axes if cut.tp_dim == d else (),
                      cols=cut.cols if cut.tp_dim == d else None,
                      dp_axes=cut.dp_axes if cut.dp_dim == d else ()).cut(
            torch.arange(size), mesh)
        inv = torch.full((size,), -1, dtype=torch.long)
        inv[mine] = torch.arange(len(mine))
        at = inv[coords[:, d]]
        held &= at >= 0
        index.append(at.clamp_min(0))
    return held, tuple(index)


def leaf_norms(grads: dict, model=None) -> dict:
    """{leaf: the f32 norm of its whole gradient}: one device's, or on a
    mesh shard (``model.cuts``) each element counted once
    (``optimizer.shard_pieces``) and summed over the mesh in one
    all-reduce."""
    import torch
    from repro_torch.training import optimizer as opt
    names = list(grads)
    if model is None or getattr(model, "cuts", None) is None:
        return {n: float(grads[n].float().norm()) for n in names}
    sq = []
    for n in names:
        ts, once = opt.shard_pieces({n: grads[n]}, model.cuts, model.comm)
        sq.append(sum(float(w) * t.float().square().sum()
                      for t, w in zip(ts, once)))
    tot = model.comm.all_reduce(torch.stack(sq), tuple(model.comm.sizes))
    return dict(zip(names, tot.sqrt().tolist()))


def t4_run(cfg, model, steps: int, host: list, dev, mesh=None,
           profile: bool = False) -> dict:
    """A T4 job's numbers: the first batch's gradient per leaf
    (``leaf_norms``), then ``steps`` AdamW steps (lr 3e-4, warm-up 1):
    their losses, grad norms and seconds, the peak device memory of the
    steps and the optimizer state's bytes; on a mesh the steps' collective
    counts, and with ``profile`` the last step under ``torch.profiler`` for
    the collectives' device share (ms per step leaves it out).  An f32 job
    also samples each leaf at ``t4_coords`` ("samples": the first batch's
    gradient, the parameters before and after the steps and the AdamW
    moments after them, as f32 CPU tensors; "held": which samples the
    rank's slice holds) and one device gives each leaf's largest gradient
    magnitude ("grad_max")."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as TR

    def put(b):
        return (device_put_batch(b, dev) if mesh is None
                else device_put_batch(b, mesh, dev))

    where = None
    if cfg.dtype == torch.float32:
        where = {}
        for n, (shape, c) in t4_coords(cfg).items():
            where[n] = ((torch.ones(len(c), dtype=torch.bool), tuple(c.T))
                        if mesh is None
                        else t4_locate(model.cuts[n], shape, c, mesh))

    def sample(ts: dict) -> dict:
        return {n: t.detach()[tuple(i.to(t.device) for i in where[n][1])]
                .float().cpu() for n, t in ts.items()}

    (_, _), g = TR.value_and_grad(lambda m, b: T.loss_fn(m, model.cfg, b),
                                  model, put(host[0]), has_aux=True)
    if mesh is not None:
        opt.sync_grads(g, model.cuts, model.comm)
    norms = leaf_norms(g, model if mesh is not None else None)
    samples = {}
    if where is not None:
        samples["grad"] = sample(g)
        samples["param0"] = sample(dict(model.named_parameters()))
        grad_max = ({n: float(t.abs().max()) for n, t in g.items()}
                    if mesh is None else None)
    del g
    state = opt.init(model)
    step = TR.build_train_step(cfg, opt.AdamWConfig(
        lr=3e-4, warmup_steps=1, total_steps=10), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if mesh is not None:
        model.comm.reset()
    losses, gnorms, secs = [], [], []
    prof = None
    for i, b in enumerate(host[:steps]):
        last = profile and i == steps - 1
        if last:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t = time.perf_counter()
        _, _, m = step(model, state, put(b))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        if last:
            prof.__exit__(None, None, None)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    # ms per step: the steps after the first, the profiled one left out
    # where another is left
    timed = (secs[1:-1] if profile else []) or secs[1:]
    out = {"leaf_norms": norms, "losses": losses, "grad_norms": gnorms,
           "step_s": secs, "ms_per_step": float(np.median(timed)) * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "opt_bytes": sum(t.nbytes for d in (state.master, state.m,
                                               state.v) for t in d.values()),
           "param_bytes": sum(p.nbytes for p in model.parameters())}
    if mesh is not None:
        out["collectives"] = dict(model.comm.stats)
        out["host_share"] = model.comm.stats["host_s"] / sum(secs)
    if prof is not None:
        out["profile_collective_ms"], out["profile_device_ms"] = \
            collective_share(prof)
    if where is not None:
        samples.update(param=sample(dict(model.named_parameters())),
                       m=sample(state.m), v=sample(state.v))
        out.update(samples=samples,
                   held={n: h for n, (h, _) in where.items()})
        if grad_max is not None:
            out["grad_max"] = grad_max
    return out


def t4_rank(i: int, job: tuple, dev, out_dir: str, rank: int) -> dict:
    """One of T4's jobs on a rank: the seeded whole model cut to the rank's
    shard (``shard_params`` under ``DEFAULT_RULES``; the whole is freed),
    then ``t4_run`` on the rank's rows, with the kernels' counts zeroed
    just before the steps and read just after (training launches none).
    An f32 job's samples go to ``out_dir/t4_<i>_rank<rank>.pt``."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.models import transformer as T
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.swarm_uncertainty import ops as uops
    arch, layers, mp, steps, dtype = job
    mesh = serving_mesh(model_parallel=mp)
    cfg, whole = t4_model(arch, layers, dtype, dev)
    shard = T.shard_params(whole, cfg, mesh, sh.Comm(mesh),
                           rules=sh.DEFAULT_RULES)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    pipe = SyntheticLMPipeline(T4_B, T4_S, seed=SEED)
    host = [pipe.get_batch(k) for k in range(steps)]
    counts = (fops.counts, dops.counts, uops.counts, fops.grid_counts,
              dops.paged_counts)
    for c in counts:
        c.reset()
    out = t4_run(cfg, shard, steps, host, dev, mesh, profile=True)
    if "samples" in out:
        torch.save({k: out.pop(k) for k in ("samples", "held")},
                   os.path.join(out_dir, f"t4_{i}_rank{rank}.pt"))
    out["launches"] = sum(c.launches for c in counts)
    out["plain"] = sum(c.plain for c in counts)
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out["local"] = {"heads": [shard.cfg.num_heads, shard.cfg.num_kv_heads],
                    "d_ff": shard.cfg.d_ff, "vocab_rows": (
                        shard.embed.shape[0]), "d_model_cols": (
                        shard.embed.shape[1]),
                    "experts": [l.ffn.w_up.shape[0] for l in shard.layers
                                if hasattr(l.ffn, "router")]}
    del shard
    return out


def d1_rank(rank: int, world: int, store: str, out_dir: str, prompts,
            jobs, device: str = "cuda"):
    """One of D1's ranks on the card, joined over gloo through a
    ``FileStore`` (NCCL refuses two ranks on one device).  For each job:
    the (data, model) mesh, the seeded model at published width (phase 4's
    and 5's weights), the mesh engine (the eager route: a gloo collective
    cannot be captured); a warm-up ``generate``, then one timed with the
    kernel counts and the collectives' counts zeroed just before and read
    just after, a profiled 2-token one for the collectives' device share,
    and a sampled one (seed ``D1_SAMPLE_SEED``).  A paged job (D2) keeps
    the timed run's session instead of the last two: it checkpoints it to
    ``out_dir/ckpt<i>`` (rank 0 writes) and extends it ``D2_EXTEND``
    tokens, and reports its pool.  A job with model options (D3,
    ``job_model``) keeps its session too, reports its state bytes, holds
    row 2 on the rank's own cache (``local_row2``) where asked, and is
    profiled but not sampled.  Writes the numbers of job i to
    ``out_dir/rank{rank}.json`` under "i", and rank 0 the tokens and
    logits of its greedy, sampled and extension runs to
    ``out_dir/job<i>.npz``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import numpy as np
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch import configs
        from repro_torch.core.uncertainty import UncertaintyConfig
        from repro_torch.kernels.decode_attention import ops as dops
        from repro_torch.kernels.decode_attention import ref as dref
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.swarm_uncertainty import ops as uops
        from repro_torch.launch.mesh import serving_mesh
        from repro_torch.serving.engine import InferenceEngine
        counts = dict(zip(KERNELS, (fops.counts, dops.counts, uops.counts,
                                    fops.grid_counts, dops.paged_counts)))
        dev = torch.device(device)
        ucfg = UncertaintyConfig(alpha=1.0, mode="distribution")
        out = {}
        for i, (arch, layers, mp, max_new, kw, *opt) in enumerate(jobs):
            opt = opt[0] if opt else {}
            if "train" in opt:                     # a T4 job
                out[str(i)] = t4_rank(i, (arch, layers, mp, max_new,
                                          opt["train"]), dev, out_dir, rank)
                gc.collect()
                torch.cuda.empty_cache()
                continue
            cfg = configs.get_config(arch)
            if layers is not None:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            mesh = serving_mesh(model_parallel=mp)
            cfg, model = job_model(cfg, opt, dev)
            eng = InferenceEngine(f"{arch}-d1", cfg, model, ucfg,
                                  device=dev, mesh=mesh, **kw)
            paged = bool(kw.get("paged"))
            del model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                sync = torch.cuda.synchronize
            else:
                def sync():
                    return None
            eng.generate(prompts, max_new)                      # warm up
            sync()
            for c in counts.values():
                c.reset()
            eng.comm.reset()
            t = time.perf_counter()
            res = eng.generate(prompts, max_new,
                               return_state=paged or bool(opt))
            sync()
            ms = (time.perf_counter() - t) * 1e3
            stats = dict(eng.comm.stats)
            launches = {n: c.launches for n, c in counts.items()}
            plain = {n: c.plain for n, c in counts.items()}
            extra, arrays = {}, {}
            coll_ms = dev_ms = 0.0
            if opt:
                st = res["state"]
                extra["state_bytes"] = (
                    eng.pool.pool_bytes if paged else sum(
                        t.nbytes for c in st.cache for t in c))
                if opt.get("row2"):
                    extra["local_row2"] = local_row2(eng, st, dops, dref,
                                                     dev, SEED + i)
                if not paged:
                    del st, res["state"]
            if paged:
                pool = eng.pool
                extra["pool"] = {
                    "n_blocks": pool.n_blocks, "n_rows": pool.n_rows,
                    "block_bytes": pool.block_bytes,
                    "pool_bytes": pool.pool_bytes,
                    "blocks_in_use": pool.blocks_in_use,
                    "kv_heads": eng._mcfg.num_kv_heads}
                st = res.pop("state")
                extra["local_row5"] = local_row5(eng, st, dops, dref, dev,
                                                 SEED + i)
                t = time.perf_counter()
                eng.checkpoint_session(st, os.path.join(out_dir,
                                                        f"ckpt{i}"))
                extra["ckpt_s"] = time.perf_counter() - t
                ext = eng.generate(None, D2_EXTEND, state=st)
                eng.release(st)
                arrays = dict(e_tokens=ext["tokens"],
                              e_logits=ext["logits"].float().cpu().numpy())
                del ext
            if opt or not paged:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                eng.generate(prompts, 2)
                with torch.profiler.profile(activities=acts) as prof:
                    eng.generate(prompts, 2)
                    sync()
                coll_ms, dev_ms = collective_share(prof)
            if not (opt or paged):
                smp = eng.generate(prompts, max_new, greedy=False,
                                   seed=D1_SAMPLE_SEED)
                arrays = dict(s_tokens=smp["tokens"],
                              s_logits=smp["logits"].float().cpu().numpy())
                del smp
            out[str(i)] = {**extra,
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "weight_bytes": eng.weight_bytes(),
                "local_heads": [eng._mcfg.num_heads,
                                eng._mcfg.num_kv_heads, eng._mcfg.d_ff],
                "launches": launches, "plain": plain,
                "ms_per_generate": ms, "collectives": stats,
                "host_share": stats["host_s"] * 1e3 / ms,
                "profile_device_ms": dev_ms, "profile_collective_ms":
                    coll_ms, "mesh_eager": eng.counters["mesh_eager"]}
            if rank == 0:
                np.savez(os.path.join(out_dir, f"job{i}.npz"),
                         tokens=res["tokens"], u=res["u"],
                         logits=res["logits"].float().cpu().numpy(),
                         **arrays)
            del eng, res, arrays
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def local_row2(eng, st, dops, dref, dev, seed: int) -> dict:
    """Row 2 on a mesh rank's own monolithic cache, against its plain
    version: the session ``st``'s first attention layer (the rank's rows
    and KV heads; a local layer's ring and window), each row's last
    written position, a seeded query over the rank's heads.  Called after
    the counted run (its launch is not counted there)."""
    import torch
    mc = eng._mcfg
    j, mixer = next((j, m) for j, (m, _) in enumerate(mc.layer_plan())
                    if m in ("attn", "attn_local"))
    c = st.cache[j]
    index = (st.pos[eng._rows(len(st.pos))] - 1).to(torch.int32)
    K, G = mc.num_kv_heads, mc.num_heads // mc.num_kv_heads
    q = torch.randn((c.k.shape[0], K, G, mc.head_dim), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed)
                    ).to(mc.dtype)
    kw = dict(window=mc.window if mixer == "attn_local" else None)
    args = (q, c.k, c.v, c.pos, index)
    out = dops.decode_attention(*args, **kw)
    ref = dref.decode_attention_ref(*args, **kw)
    return {"max_abs_err": float((out.float() - ref.float()).abs().max()),
            "finite": bool(torch.isfinite(out).all()), "tol": 2e-2,
            "shape": {"B": c.k.shape[0], "K": K, "G": G, "D": mc.head_dim,
                      "T": c.k.shape[1], "window": kw["window"],
                      "dtype": str(c.k.dtype)}}


def local_row5(eng, st, dops, dref, dev, seed: int) -> dict:
    """Row 5 on a mesh rank's own pool, against its plain version: the
    rank's first attention layer's served blocks (their local ids; an
    int8 pool with its scales), the session ``st``'s tables of the rank's
    rows, each row's last written position, a seeded query over the
    rank's KV heads.  Called after the counted run (its launch is not
    counted there)."""
    import torch
    from repro_torch.models.attention import KVPool
    mc, h = eng._mcfg, st.cache
    sv = next(a for a in eng.pool.arrays if isinstance(a, KVPool)).served()
    table = torch.as_tensor(h.tables, device=dev)
    index = (st.pos[eng._rows(len(st.pos))] - 1).to(torch.int32)
    K, G = mc.num_kv_heads, mc.num_heads // mc.num_kv_heads
    q = torch.randn((table.shape[0], K, G, mc.head_dim), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed)
                    ).to(mc.dtype)
    args = (q, sv.k, sv.v, sv.pos, table, index)
    kw = dict(k_scale=sv.k_scale, v_scale=sv.v_scale)
    out = dops.paged_decode_attention(*args, **kw)
    ref = dref.paged_decode_attention_ref(*args, **kw)
    return {"max_abs_err": float((out.float() - ref.float()).abs().max()),
            "finite": bool(torch.isfinite(out).all()), "tol": 2e-2,
            "shape": {"B": table.shape[0], "K": K, "G": G, "D": mc.head_dim,
                      "N": sv.k.shape[0], "nb": table.shape[1],
                      "pool": str(sv.k.dtype)}}


def wall_ms(torch, fn, n=3) -> float:
    """Median wall ms of ``n`` synchronised calls of ``fn``."""
    import numpy as np
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def differ(a, b) -> dict:
    """The fields of two ``generate`` results that are not bitwise equal,
    with their largest difference."""
    import numpy as np
    import torch
    out = {}
    for k in ("tokens", "logits", "u", "h_mean", "v_mean"):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        if not np.array_equal(x, y):
            out[k] = float(np.abs(np.asarray(x, np.float64)
                                  - np.asarray(y, np.float64)).max())
    return out


def mesh11_generate(c, phase: str, label: str, base, me, mn: int, needs,
                    forbid) -> dict:
    """``me`` (an engine on the (1, 1) mesh) against ``base`` (the same
    engine on one device), phase 4's prompts, ``mn`` tokens: a counted
    ``generate`` (``needs`` launched, ``forbid`` not, no plain version)
    bitwise ``base``'s, no collective, one graph launch per ``generate``
    (profiled at ``max_new=2``), ms per ``generate`` beside ``base``'s in
    turns.  Returns its numbers."""
    np, torch = c.np, c.torch
    CPU = torch.profiler.ProfilerActivity.CPU
    CUDA = torch.profiler.ProfilerActivity.CUDA
    pr = c.prompts
    check(me._graphs is not None and not me._multi_rank
          and not any(hasattr(m, "tp") for m in me.params.modules()),
          f"{phase} {label}: the (1, 1) mesh engine does not capture, or its "
          "model would cross the mesh")
    me.generate(pr, mn)                                  # capture
    base.generate(pr, mn)
    torch.cuda.synchronize()
    r1 = c.counted(f"mesh11 {label} generate", needs,
                   lambda: me.generate(pr, mn), forbid=forbid)
    d = differ(r1, base.generate(pr, mn))
    check(not d, f"{phase} {label}: the (1, 1) mesh engine's generate is "
                 f"not bitwise the single-device engine's: {d}")
    check(me.comm.stats["all_reduce"] + me.comm.stats["all_gather"]
          + me.comm.stats["agree"] == 0,
          f"{phase} {label}: collectives on a (1, 1) mesh")
    me.generate(pr, 2)                                   # capture
    st0 = dict(me._graphs.stats)
    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        with torch.profiler.record_function(f"{phase} generate"):
            me.generate(pr, 2)
        torch.cuda.synchronize()
    st1 = dict(me._graphs.stats)
    calls = runtime_calls(prof, f"{phase} generate")
    check(calls["graph_launches_all"] == 1
          and st1["replays"] == st0["replays"] + 1
          and st1["captures"] == st0["captures"],
          f"{phase} {label}: {calls['graph_launches_all']} graph launches, "
          f"{st1['replays'] - st0['replays']} replays and "
          f"{st1['captures'] - st0['captures']} captures in one "
          "generate, want 1, 1, 0")
    turns = [(n, wall_ms(torch, lambda e=e: e.generate(pr, mn)))
             for n, e in (("single", base), ("mesh", me), ("mesh", me),
                          ("single", base))]
    ms_s = float(np.mean([t for n, t in turns if n == "single"]))
    ms_m = float(np.mean([t for n, t in turns if n == "mesh"]))
    print(f"[{phase}] (1, 1) mesh {label} generate B=8 max_new={mn}: "
          f"bitwise the single-device engine; one graph launch; {ms_m:.2f} "
          f"ms against {ms_s:.2f} ms single-device (turns "
          + ", ".join(f"{n} {t:.2f}" for n, t in turns) + ")")
    return {"max_new": mn, "ms_single": ms_s, "ms_mesh": ms_m,
            "turns_ms": turns, "weight_bytes": me.weight_bytes(),
            "graph_launches": calls["graph_launches_all"],
            "kernel_launches_host": calls["kernel_launches_all"]}


def spawn_ranks(c, jobs, name: str, limit: float = 400):
    """``d1_rank`` on two ranks of the one card for ``jobs``, spawned after
    the build, their numbers and arrays under ``build/<name>``; a failed or
    late rank fails the script.  Returns (each rank's numbers, seconds,
    the directory)."""
    out_dir = ROOT / "build" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = c.torch.multiprocessing.start_processes(
        d1_rank, args=(2, str(out_dir / "store"), str(out_dir), c.prompts,
                       jobs, c.dev.type),
        nprocs=2, join=False, start_method="spawn")
    tag = name.upper()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > limit:
                fail(f"{tag}: the two ranks did not finish in {limit} s")
    except Exception as e:          # a rank raised or died: fail the script
        fail(f"{tag}: a rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(2)]
    return ranks, time.perf_counter() - t0, out_dir


def t4_reference(c) -> list:
    """T4's jobs on one device, run by the parent before D1's spawn (so
    that no rank holds a second whole model): ``t4_run`` on the whole
    batch of each, the model freed after it."""
    torch = c.torch
    from repro_torch.data.pipeline import SyntheticLMPipeline
    refs = []
    t0 = time.perf_counter()
    for arch, layers, mp, steps, dtype in T4_JOBS:
        cfg, model = t4_model(arch, layers, dtype, c.dev)
        pipe = SyntheticLMPipeline(T4_B, T4_S, seed=SEED)
        host = [pipe.get_batch(k) for k in range(steps)]
        refs.append(t4_run(cfg, model, steps, host, c.dev))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[T4] one-device references of the rank jobs "
          f"{time.perf_counter() - t0:.1f} s")
    return refs


def t4_held_to(ref: dict, files: list) -> dict:
    """An f32 T4 job's sampled elements (``t4_run``) on the ranks against
    one device's, leaf by leaf, each element from every rank that holds
    it: the first gradient's largest difference over the leaf's largest
    gradient magnitude ("grad", budget 1e-2: the CPU tests' port-numerics
    budget, where a last-bit difference of a split product flips a bf16
    rounding of q, k, v or P; an MoE layer's router and routed experts,
    "grad_routed", budget 5e-2: there such a difference can also swap two
    near-tied experts of a token, whose share of their gradients then
    moves: 2.1e-2 of the router's largest on an H100 at full width); the
    parameters and both moments after the steps, largest difference
    ("param", "m", "v", budget 5e-3 as the CPU tests, which lr 3e-4 over 3
    steps keeps the parameters within whatever the update); the first
    moment over the leaf's largest ("m_rel": a gradient scaled on one
    rank moves it by ~1, which Adam's normalised update hides) and the
    update the steps made, the L2 norm of its difference over its own
    ("update_rel": a wrong step size or moment moves it by ~1).  Returns
    {measure: (worst value, its leaf)} and the leaves whose samples no
    rank holds."""
    import torch
    got = [torch.load(f) for f in files]
    want = ref["samples"]
    routed = {n[:-len("router")] + w for n in want["grad"]
              if n.endswith(".router")
              for w in ("router", "w_gate", "w_up", "w_down")}
    worst: dict = {}
    uncovered = []

    def note(k, v, n):
        if k not in worst or v > worst[k][0]:
            worst[k] = (v, n)

    for n in want["grad"]:
        held = [g["held"][n] for g in got]
        if not torch.stack(held).any(0).all():
            uncovered.append(n)
        d = {k: max((float((g["samples"][k][n] - want[k][n])[h].abs()
                           .max()) if h.any() else 0.0)
                    for g, h in zip(got, held))
             for k in ("grad", "param", "m", "v")}
        note("grad_routed" if n in routed else "grad",
             d["grad"] / max(ref["grad_max"][n], 1e-30), n)
        for k in ("param", "m", "v"):
            note(k, d[k], n)
        note("m_rel", d["m"] / max(float(want["m"][n].abs().max()), 1e-30),
             n)
        du = []
        for g, h in zip(got, held):
            up = g["samples"]["param"][n] - g["samples"]["param0"][n]
            du.append((up - (want["param"][n] - want["param0"][n]))[h])
        du = torch.cat(du)
        base = float((want["param"][n] - want["param0"][n]).norm())
        note("update_rel", float(du.norm()) / max(base, 1e-30)
             * math.sqrt(T4_SAMPLES / max(len(du), 1)), n)
    return worst, uncovered


T4_BUDGET = {"grad": 1e-2, "grad_routed": 5e-2, "param": 5e-3, "m": 5e-3,
             "v": 5e-3, "m_rel": 5e-2, "update_rel": 0.5}


def phase_t4_ranks(c, ranks, first: int, refs: list, out_dir):
    """T4's two-rank jobs (spawned with D1's, indices from ``first``)
    against the parent's one-device runs: an f32 job's sampled elements of
    every leaf within ``T4_BUDGET`` (``t4_held_to``: the first gradient
    per element, the parameters, moments and update after the steps), the
    first-batch gradient norm of every leaf within rtol 1e-2 (a missing
    ``enter`` or a sum over the wrong axes moves a leaf's by a factor),
    its first step's loss within rtol 1e-5 and grad norm within rtol 2e-4,
    and the later steps' losses within rtol 1e-3, looser than the CPU
    tests' 1e-5 because those hold only one step at the port's numerics:
    after a step, Adam's normalised update moves an element whose
    gradient a flipped bf16 rounding turned over by ~2 lr, and the loss
    with it (2.6e-4 seen); the bf16 job's losses within TIE_ATOL; every
    rank the same metrics, no kernel and no plain version launched;
    ms/step, collectives, host and device share, peak GB and optimizer
    bytes a rank against one device."""
    np = c.np
    rep = {}
    for j, ((arch, layers, mp, steps, dtype), ref) in enumerate(
            zip(T4_JOBS, refs)):
        xs = [rr[str(first + j)] for rr in ranks]
        tag = f"T4 {arch} {dtype} on {xs[0]['mesh']}"
        for r, x in enumerate(xs):
            check(x["launches"] == 0 and x["plain"] == 0,
                  f"{tag} rank {r}: {x['launches']} kernel launches, "
                  f"{x['plain']} plain versions")
            check(x["losses"] == xs[0]["losses"]
                  and x["grad_norms"] == xs[0]["grad_norms"],
                  f"{tag}: the ranks' metrics differ")
        x = xs[0]
        dl = [abs(a - b) / abs(b) for a, b in zip(x["losses"],
                                                   ref["losses"])]
        dg = [abs(a - b) / abs(b) for a, b in zip(x["grad_norms"],
                                                   ref["grad_norms"])]
        held = None
        if dtype == "float32":
            bad = {n: (x["leaf_norms"][n], v)
                   for n, v in ref["leaf_norms"].items()
                   if abs(x["leaf_norms"][n] - v) > 1e-2 * v + 1e-12}
            check(not bad, f"{tag}: leaf gradient norms differ: "
                           f"{list(bad.items())[:4]}")
            held, uncovered = t4_held_to(ref, [
                out_dir / f"t4_{first + j}_rank{r}.pt"
                for r in range(len(xs))])
            check(not uncovered, f"{tag}: no rank holds the samples of "
                                 f"{uncovered[:4]}")
            over = {k: v for k, v in held.items() if v[0] > T4_BUDGET[k]}
            check(not over, f"{tag}: sampled elements past {T4_BUDGET}: "
                            f"{over}")
            check(dl[0] <= 1e-5 and dg[0] <= 2e-4
                  and max(dl[1:]) <= 1e-3,
                  f"{tag}: losses {x['losses']} vs {ref['losses']}, grad "
                  f"norms {x['grad_norms']} vs {ref['grad_norms']}")
        else:
            worst = max(abs(a - b) for a, b in zip(x["losses"],
                                                   ref["losses"]))
            check(worst <= TIE_ATOL, f"{tag}: losses {x['losses']} vs "
                                     f"{ref['losses']}")
        ms, ms1 = x["ms_per_step"], ref["ms_per_step"]
        st = x["collectives"]
        share = x["profile_collective_ms"] / max(x["profile_device_ms"],
                                                 1e-9)
        worst_leaf = (max(abs(x["leaf_norms"][n] - v) / max(v, 1e-30)
                          for n, v in ref["leaf_norms"].items())
                      if dtype == "float32" else None)
        print(f"[T4] {arch} {dtype} ({'all' if layers is None else layers}"
              f" layers) on {x['mesh']}: local {x['local']}; losses "
              f"{[round(v, 5) for v in x['losses']]} (one device "
              f"{[round(v, 5) for v in ref['losses']]}, rel "
              f"{[f'{v:.1e}' for v in dl]}), grad norm rel "
              f"{[f'{v:.1e}' for v in dg]}, worst leaf norm rel "
              f"{'not held' if worst_leaf is None else f'{worst_leaf:.1e}'}"
              f"; {ms:.1f} ms/step a rank vs {ms1:.1f} one device; "
              f"{st['all_reduce']} all-reduce + {st['all_gather']} "
              f"all-gather in {steps} steps, {st['bytes'] / 1e6:.1f} MB "
              f"given, {st['staged_bytes'] / 1e6:.1f} MB staged; host share "
              f"{x['host_share']:.3f}, device share {share:.3f} "
              f"({x['profile_collective_ms']:.1f} of "
              f"{x['profile_device_ms']:.1f} device ms, the last step); peak "
              f"{x['peak_gb']:.2f} GB a rank vs {ref['peak_gb']:.2f}, "
              f"optimizer state {x['opt_bytes'] / 1e9:.3f} GB a rank vs "
              f"{ref['opt_bytes'] / 1e9:.3f}")
        if held is not None:
            print(f"[T4]   {T4_SAMPLES} sampled elements a leaf, worst "
                  f"against one device (budget): " + ", ".join(
                      f"{k} {v:.2e} ({T4_BUDGET[k]:g}, {n})"
                      for k, (v, n) in held.items()))
        for k in ("samples", "held", "grad_max"):
            ref.pop(k, None)
        rep[f"{arch}-{dtype}"] = {
            "per_rank": xs, "reference": ref, "ms_per_step": ms,
            "ms_per_step_one_device": ms1, "loss_rel": dl,
            "grad_norm_rel": dg, "worst_leaf_norm_rel": worst_leaf,
            "device_share": share, "sampled": held}
    return rep


def phase_d1(c):
    """D1. serving on a (data, model) mesh.  In process, on the (1, 1)
    NCCL mesh (a world of one over a ``HashStore``): the probe at full
    width and depth (phase 4's prompts, ``max_new=32``) and ``llama3-8b``
    (4 layers, 16 tokens), each engine on phase 4's and 5's weights —
    ``generate`` bitwise the single-device engine's (tokens, logits, u,
    h/v means), one graph launch per ``generate`` (profiled at
    ``max_new=2``), rows 1-3 launched and no plain version, ms per
    ``generate`` beside the single-device engine's in turns.  Then two
    ranks on the one card over gloo, spawned after the build (``d1_rank``):
    ``llama3-8b`` 4 layers on (data=1, model=2) (H32/K8: case (a)) and the
    probe on (data=2, model=1), tokens tie-aware equal to the single-device
    engine's, greedy and sampled (seed ``D1_SAMPLE_SEED``: a stream that
    depends on the batch's split fails), each rank's weight bytes, kernels
    launched, ms per ``generate`` and the collectives' share of the host
    and device time; a failed rank fails the script."""
    np, torch = c.np, c.torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import serving_mesh
    t_ph = time.perf_counter()
    mesh = serving_mesh(device=c.dev)
    check(sh.axis_sizes(mesh) == {"data": 1, "model": 1}
          and torch.distributed.get_backend() == (
              "nccl" if c.dev.type == "cuda" else "gloo"),
          f"D1: the mesh of one card is {sh.axis_sizes(mesh)} over "
          f"{torch.distributed.get_backend()}")
    c.mesh11 = mesh
    rep = {"mesh11": {}, "ranks": {}}
    for label, base, mn in (("smollm", c.probe, c.max_new),
                            ("llama3", c.cloud, 16)):
        me = c.InferenceEngine(base.name + "-mesh11", base.cfg, base.params,
                               base.ucfg, mesh=mesh)
        rep["mesh11"][label] = mesh11_generate(
            c, "D1", label, base, me, mn, SERVE_KERNELS,
            ("paged_decode_attention",))
        del me

    # two ranks on the one card, spawned after the build, for D1's, D2's
    # and D3's jobs (one spawn: each costs the ranks' start and CUDA
    # contexts)
    t4_refs = t4_reference(c)
    t4_jobs = tuple((a, l, mp, n, {}, {"train": dt})
                    for a, l, mp, n, dt in T4_JOBS)
    ranks, t_ranks, out_dir = spawn_ranks(
        c, D1_JOBS + D2_JOBS + D3_JOBS + t4_jobs, "d1")
    c.d2_ranks = ranks, out_dir
    c.t4 = {"ranks": phase_t4_ranks(
        c, ranks, len(D1_JOBS + D2_JOBS + D3_JOBS), t4_refs, out_dir)}
    refs = {"llama3-8b": (c.cloud, 16), "smollm-135m": (c.probe, c.max_new)}
    for j, (arch, layers, mp, mn, _) in enumerate(D1_JOBS):
        got = np.load(out_dir / f"job{j}.npz")
        ranks_j = [rr[str(j)] for rr in ranks]
        eng, n = refs[arch]
        ref = eng.generate(c.prompts, n)
        flips, reading, dlog = tie_aware(
            f"D1 {arch} on {ranks_j[0]['mesh']}", got["tokens"],
            ref["tokens"], ref["logits"].float().cpu().numpy(),
            got["logits"])
        sref = eng.generate(c.prompts, n, greedy=False, seed=D1_SAMPLE_SEED)
        s_lr = sref["logits"].float().cpu().numpy()
        check(not np.array_equal(sref["tokens"], ref["tokens"]),
              f"D1 {arch}: the sampled stream is the greedy one")
        s_flips, s_reading, s_dlog = tie_aware(
            f"D1 {arch} sampled on {ranks_j[0]['mesh']}",
            got["s_tokens"], sref["tokens"], s_lr, got["s_logits"],
            noise=race_noise(D1_SAMPLE_SEED, *s_lr.shape, c.dev))
        del sref, s_lr
        for r, x in enumerate(ranks_j):
            for k in SERVE_KERNELS:
                check(x["launches"][k] > 0,
                      f"D1 {arch} rank {r}: {k} was never launched")
            check(sum(x["plain"].values()) == 0,
                  f"D1 {arch} rank {r}: plain versions ran: {x['plain']}")
            check(x["mesh_eager"] > 0, f"D1 {arch} rank {r}: no dispatch "
                                       "on the eager route")
            dev_share = (x["profile_collective_ms"]
                         / max(x["profile_device_ms"], 1e-9))
            x["device_share"] = dev_share
            print(f"[D1] {arch} on {x['mesh']} rank {r}: weights "
                  f"{x['weight_bytes'] / 1e9:.4f} GB (heads/KV heads/d_ff "
                  f"{x['local_heads']}), {x['ms_per_generate']:.1f} ms per "
                  f"generate (B=8, {mn} tokens, eager), launches "
                  f"{ {k: v for k, v in x['launches'].items() if v} }, "
                  f"collectives {x['collectives']['all_reduce']} all-reduce "
                  f"+ {x['collectives']['all_gather']} all-gather, "
                  f"{x['collectives']['bytes'] / 1e6:.1f} MB, "
                  f"{x['collectives']['staged_bytes'] / 1e6:.1f} MB staged "
                  f"through the host; host share {x['host_share']:.3f}, "
                  f"device share {dev_share:.4f} "
                  f"({x['profile_collective_ms']:.2f} of "
                  f"{x['profile_device_ms']:.2f} device ms, a 2-token "
                  "generate)")
        print(f"[D1] {arch} on {ranks_j[0]['mesh']}: tie-aware equal to "
              f"the single-device engine ({flips} rows diverged at a tie, "
              f"logits {dlog:.4f} apart, reading {reading:.3f}); sampled "
              f"seed {D1_SAMPLE_SEED}: {s_flips} rows diverged, logits "
              f"{s_dlog:.4f} apart, reading {s_reading:.3f}")
        rep["ranks"][arch] = {"per_rank": ranks_j,
                              "tie_flips": flips, "tie_reading": reading,
                              "max_dlogit": dlog, "sampled_flips": s_flips,
                              "sampled_reading": s_reading,
                              "sampled_max_dlogit": s_dlog}
    rep["ranks_s"] = t_ranks
    rep["phase_s"] = time.perf_counter() - t_ph
    print(f"[D1] two ranks (D1's, D2's, D3's and T4's jobs) {t_ranks:.1f} s; "
          "phase "
          f"{rep['phase_s']:.1f} s")
    c.report["mesh"] = rep


def phase_d2(c):
    """D2. the paged pool, quantized weights and pools, and session
    checkpoints on a mesh.  On the (1, 1) NCCL mesh: the probe (30 layers,
    phase 4's prompts, 16 tokens) paged, and ``llama3-8b`` (4 layers) with
    int8 weights and an int8 pool, each ``generate`` bitwise its
    single-device engine's with one graph launch (``mesh11_generate``).
    Then two gloo ranks on the card (``d1_rank``, ``D2_JOBS``, spawned
    with D1's jobs in ``phase_d1``): the probe
    paged on (data=2, model=1) and ``llama3-8b`` paged with an int8 pool on
    (1, 2), tie-aware equal to their single-device engines, row 5 launched
    on each rank's local pool (half the blocks and rows; 4 of the 8 KV
    heads) and no plain version; each session checkpointed on the mesh
    (rank 0 writes) and restored on one device, its extension tie-aware
    equal to the mesh's uninterrupted one (and that one to one device's on
    the rows that have not flipped at a tie)."""
    np, torch = c.np, c.torch
    t_ph = time.perf_counter()
    rep = {"mesh11": {}, "ranks": {}}
    base_p = c.paged4g["kernel"]
    check(base_p.pool.n_blocks == D2_POOL["pool_blocks"]
          and base_p.attn_decode_impl == "kernel",
          "D2: phase 4g's paged probe is not the D2 pool")
    me = c.InferenceEngine("probe-paged-mesh11", c.cfg, c.probe.params,
                           c.ucfg, mesh=c.mesh11, **D2_POOL)
    rep["mesh11"]["smollm paged"] = mesh11_generate(
        c, "D2", "smollm paged", base_p, me, 16, PAGED_SERVE,
        ("decode_attention",))
    del me
    qkw = dict(D2_POOL, cache_quant="int8", weight_quant="int8")
    base_q = c.InferenceEngine("llama3-q", c.lcfg, c.cloud.params, c.ucfg,
                               **qkw)
    me = c.InferenceEngine("llama3-q-mesh11", c.lcfg, c.cloud.params,
                           c.ucfg, mesh=c.mesh11, **qkw)
    check(me.weight_bytes() == base_q.weight_bytes(),
          "D2: the (1, 1) mesh's quantized weights are not one device's")
    rep["mesh11"]["llama3 int8"] = mesh11_generate(
        c, "D2", "llama3 int8", base_q, me, 16, PAGED_SERVE,
        ("decode_attention",))
    del me, base_q
    torch.cuda.empty_cache()

    ranks, out_dir = c.d2_ranks
    refs = {"smollm-135m": base_p,
            "llama3-8b": c.InferenceEngine("llama3-int8pool", c.lcfg,
                                           c.cloud.params, c.ucfg,
                                           **dict(D2_POOL,
                                                  cache_quant="int8"))}
    for j, (arch, layers, mp, mn, kw) in enumerate(D2_JOBS, len(D1_JOBS)):
        got = np.load(out_dir / f"job{j}.npz")
        ranks_j = [rr[str(j)] for rr in ranks]
        eng = refs[arch]
        ref = eng.generate(c.prompts, mn, return_state=True)
        where = f"D2 {arch} {kw} on {ranks_j[0]['mesh']}"
        flips, reading, dlog = tie_aware(
            where, got["tokens"], ref["tokens"],
            ref["logits"].float().cpu().numpy(), got["logits"])
        ext = eng.generate(None, D2_EXTEND, state=ref["state"])
        eng.release(ref["state"])
        # the mesh's uninterrupted extension against one device's, on the
        # rows whose streams agree so far (a row that flipped at a tie
        # continues another history)
        same = [b for b in range(len(ref["tokens"]))
                if np.array_equal(got["tokens"][b], ref["tokens"][b])]
        check(len(same) > 0, f"{where}: every row flipped")
        e_flips, e_reading, _ = tie_aware(
            where + " extension", got["e_tokens"][same],
            ext["tokens"][same], ext["logits"].float().cpu().numpy()[same],
            got["e_logits"][same])
        # the session restored on one device and extended there, against
        # the mesh's uninterrupted extension of the same session
        t0 = time.perf_counter()
        st = eng.restore_session(str(out_dir / f"ckpt{j}"))
        t_restore = time.perf_counter() - t0
        res = eng.generate(None, D2_EXTEND, state=st)
        eng.release(st)
        r_flips, r_reading, r_dlog = tie_aware(
            where + " checkpoint restored on one device", res["tokens"],
            got["e_tokens"], got["e_logits"],
            res["logits"].float().cpu().numpy())
        blocks = eng.pool_blocks
        for r, x in enumerate(ranks_j):
            for k in PAGED_SERVE:
                check(x["launches"][k] > 0,
                      f"{where} rank {r}: {k} was never launched")
            check(x["launches"]["decode_attention"] == 0
                  and sum(x["plain"].values()) == 0,
                  f"{where} rank {r}: row 2 or plain versions ran: "
                  f"{x['launches']} {x['plain']}")
            l5 = x["local_row5"]
            check(l5["finite"] and l5["max_abs_err"] <= l5["tol"],
                  f"{where} rank {r}: row 5 on its local pool {l5['shape']} "
                  f"is {l5['max_abs_err']} from its plain version (tol "
                  f"{l5['tol']})")
            print(f"[D2] {arch} on {x['mesh']} rank {r}: row 5 on its own "
                  f"pool {l5['shape']}: err {l5['max_abs_err']:.2e} against "
                  f"its plain version (tol {l5['tol']:g})")
            d = x["mesh"]["data"]
            check(x["pool"]["n_blocks"] == blocks // d
                  and x["pool"]["kv_heads"] == x["local_heads"][1],
                  f"{where} rank {r}: its pool {x['pool']} is not its share "
                  f"of {blocks} blocks over data={d}")
            print(f"[D2] {arch} on {x['mesh']} rank {r}: pool "
                  f"{x['pool']['n_blocks']} blocks of "
                  f"{x['pool']['block_bytes'] / 1e6:.3f} MB "
                  f"({x['pool']['pool_bytes'] / 1e9:.3f} GB, "
                  f"{x['pool']['kv_heads']} KV heads), weights "
                  f"{x['weight_bytes'] / 1e9:.4f} GB, "
                  f"{x['ms_per_generate']:.1f} ms per generate (B=8, {mn} "
                  f"tokens, eager), launches "
                  f"{ {k: v for k, v in x['launches'].items() if v} }, "
                  f"collectives {x['collectives']['all_reduce']} all-reduce "
                  f"+ {x['collectives']['all_gather']} all-gather + "
                  f"{x['collectives']['agree']} agreements, "
                  f"{x['collectives']['bytes'] / 1e6:.1f} MB, "
                  f"{x['collectives']['staged_bytes'] / 1e6:.1f} MB staged; "
                  f"host share {x['host_share']:.3f}; checkpoint "
                  f"{x['ckpt_s']:.2f} s")
        print(f"[D2] {where}: tie-aware equal to the single-device engine "
              f"({flips} rows diverged at a tie, logits {dlog:.4f} apart, "
              f"reading {reading:.3f}); extension ({len(same)} rows) reading "
              f"{e_reading:.3f}; "
              f"restored on one device in {t_restore:.2f} s, extension "
              f"{r_flips} rows diverged, logits {r_dlog:.4f} apart, reading "
              f"{r_reading:.3f}")
        rep["ranks"][arch] = {
            "kw": kw, "per_rank": ranks_j,
            "tie_flips": flips, "tie_reading": reading, "max_dlogit": dlog,
            "extension_reading": e_reading, "restore_s": t_restore,
            "restored_flips": r_flips, "restored_reading": r_reading,
            "restored_max_dlogit": r_dlog}
    del refs
    torch.cuda.empty_cache()
    rep["phase_s"] = time.perf_counter() - t_ph
    print(f"[D2] phase {rep['phase_s']:.1f} s (its rank jobs ran in D1's "
          "spawn)")
    c.report["mesh_paged"] = rep


def phase_d3(c):
    """D3 (ranks). The recurrent mixers and MoE expert parallelism on two
    gloo ranks of the card (``d1_rank``, ``D3_JOBS``, spawned with D1's
    jobs in ``phase_d1``), each on (data=1, model=2) as an f32 copy:
    ``recurrentgemma-2b`` (5 layers: W 1280 per rank, its local attention
    in placement (b), 5 of 10 query heads on the one KV head),
    ``mamba2-780m`` (4 layers: 24 of 48 SSD heads per rank) and
    ``deepseek-moe-16b`` paged (3 layers: 32 of 64 experts per rank);
    B=8, phase 4's prompts, 16 tokens, tie-aware equal to the single-device
    engine on the same f32 weights, the path's kernels launched on each
    rank and no plain version, row 2 held on a rank's own cache and row 5
    on its own pool against their plain versions; the deepseek session
    checkpointed on the mesh and restored on one device, its extension
    tie-aware the mesh's uninterrupted one.  Per rank: ms per ``generate``,
    weight and state bytes, the collectives' count, bytes and device
    share.  The (1, 1) mesh's half of D3 runs beside R1-M2
    (``d3_mesh11`` in ``main``)."""
    np, torch = c.np, c.torch
    t_ph = time.perf_counter()
    ranks, out_dir = c.d2_ranks
    rep = {"ranks": {}}
    needs = {"recurrentgemma-2b": SERVE_KERNELS,
             "mamba2-780m": ("swarm_uncertainty",),
             "deepseek-moe-16b": PAGED_SERVE}
    for j, (arch, layers, mp, mn, kw, opt) in enumerate(
            D3_JOBS, len(D1_JOBS) + len(D2_JOBS)):
        got = np.load(out_dir / f"job{j}.npz")
        ranks_j = [rr[str(j)] for rr in ranks]
        cfg = c.configs.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cfg, model = job_model(cfg, opt, c.dev)
        eng = c.InferenceEngine(f"{arch}-d3", cfg, model, c.ucfg, **kw)
        paged = bool(kw.get("paged"))
        ref = eng.generate(c.prompts, mn, return_state=paged)
        where = f"D3 {arch} f32 {kw or ''} on {ranks_j[0]['mesh']}"
        flips, reading, dlog = tie_aware(
            where, got["tokens"], ref["tokens"],
            ref["logits"].float().cpu().numpy(), got["logits"])
        check(np.isfinite(got["logits"]).all()
              and got["tokens"].shape == (len(c.prompts), mn),
              f"{where}: tokens or logits malformed")
        jr = {"kw": kw, "opt": opt, "per_rank": ranks_j,
              "tie_flips": flips, "tie_reading": reading,
              "max_dlogit": dlog}
        if paged:
            ext = eng.generate(None, D2_EXTEND, state=ref["state"])
            eng.release(ref["state"])
            t0 = time.perf_counter()
            st = eng.restore_session(str(out_dir / f"ckpt{j}"))
            jr["restore_s"] = time.perf_counter() - t0
            res = eng.generate(None, D2_EXTEND, state=st)
            eng.release(st)
            jr["restored"] = list(tie_aware(
                where + " checkpoint restored on one device", res["tokens"],
                got["e_tokens"], got["e_logits"],
                res["logits"].float().cpu().numpy()))
            same = [b for b in range(len(ref["tokens"]))
                    if np.array_equal(got["tokens"][b], ref["tokens"][b])]
            check(len(same) > 0, f"{where}: every row flipped")
            jr["extension"] = list(tie_aware(
                where + " extension", got["e_tokens"][same],
                ext["tokens"][same],
                ext["logits"].float().cpu().numpy()[same],
                got["e_logits"][same]))
            del ext, res
        for r, x in enumerate(ranks_j):
            for k in needs[arch]:
                check(x["launches"][k] > 0,
                      f"{where} rank {r}: {k} was never launched")
            check(sum(x["plain"].values()) == 0,
                  f"{where} rank {r}: plain versions ran: {x['plain']}")
            check(x["mesh_eager"] > 0, f"{where} rank {r}: no dispatch on "
                                       "the eager route")
            for row in ("local_row2", "local_row5"):
                lr = x.get(row)
                if lr is None:
                    continue
                check(lr["finite"] and lr["max_abs_err"] <= lr["tol"],
                      f"{where} rank {r}: {row} on its own cache "
                      f"{lr['shape']} is {lr['max_abs_err']} from its plain "
                      f"version (tol {lr['tol']})")
                print(f"[D3] {arch} rank {r}: {row[6:]} on its own "
                      f"{'pool' if row == 'local_row5' else 'cache'} "
                      f"{lr['shape']}: err {lr['max_abs_err']:.2e} (tol "
                      f"{lr['tol']:g})")
            x["device_share"] = (x["profile_collective_ms"]
                                 / max(x["profile_device_ms"], 1e-9))
            cs = x["collectives"]
            print(f"[D3] {arch} on {x['mesh']} rank {r}: "
                  f"{x['ms_per_generate']:.1f} ms per generate (B=8, {mn} "
                  f"tokens, f32, eager), weights "
                  f"{x['weight_bytes'] / 1e9:.4f} GB, state "
                  f"{x['state_bytes'] / 1e9:.4f} GB, launches "
                  f"{ {k: v for k, v in x['launches'].items() if v} }, "
                  f"collectives {cs['all_reduce']} all-reduce + "
                  f"{cs['all_gather']} all-gather + {cs['agree']} "
                  f"agreements, {cs['bytes'] / 1e6:.1f} MB, "
                  f"{cs['staged_bytes'] / 1e6:.1f} MB staged; host share "
                  f"{x['host_share']:.3f}, device share "
                  f"{x['device_share']:.4f} ({x['profile_collective_ms']:.2f}"
                  f" of {x['profile_device_ms']:.2f} device ms, a 2-token "
                  "generate)")
        print(f"[D3] {where}: tie-aware equal to the single-device engine "
              f"({flips} rows diverged at a tie, logits {dlog:.2e} apart, "
              f"reading {reading:.3f})"
              + (f"; checkpoint restored on one device in "
                 f"{jr['restore_s']:.2f} s, its extension reading "
                 f"{jr['restored'][1]:.3f}" if paged else ""))
        rep["ranks"][arch] = jr
        del eng, model, ref
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    rep["phase_s"] = time.perf_counter() - t_ph
    print(f"[D3] ranks' phase {rep['phase_s']:.1f} s (its rank jobs ran in "
          "D1's spawn)")
    c.report["mesh_d3"] = rep


def phase_d1_gateway(c):
    """D1 (gateway). Phase 7's tiers and classifier through
    ``gateway_from_weights(mesh=...)`` on the (1, 1) NCCL mesh, with phase
    7's router config and its warm-up-then-counted sequence: the same
    decisions and u, bitwise, rows 1-4 launched and no plain version."""
    np, torch = c.np, c.torch
    t_ph = time.perf_counter()
    mgw, mprobe, mcloud, _ = c.gateway_from_weights(
        **c.tiers, safety=c.safety, router_cfg=c.gw.router_cfg,
        mesh=c.mesh11)
    check(mprobe.mesh is c.mesh11 and mgw.safety_params is not None,
          "D1 gateway: the tiers are not on the mesh")
    mgw.answer_batch(c.queries)                      # warm up, as phase 7
    torch.cuda.synchronize()
    mgw.reset_fault_state()
    t0 = time.perf_counter()
    mlog = c.counted("mesh11 gateway answer_batch", MONO_KERNELS,
                     lambda: mgw.answer_batch(c.queries),
                     forbid=("paged_decode_attention",))
    t_b = time.perf_counter() - t0
    check(np.array_equal(mlog.decision, c.log.decision)
          and np.array_equal(mlog.u, c.log.u)
          and np.array_equal(mlog.answers, c.log.answers),
          "D1 gateway: decisions, u or answers differ from phase 7's")
    c.report["mesh"]["gateway"] = {"answer_batch_s": t_b,
                                   "phase_s": time.perf_counter() - t_ph}
    print(f"[D1] gateway answer_batch on the (1, 1) mesh: {t_b:.3f} s, "
          "decisions, u and answers equal phase 7's")
    del mgw, mprobe, mcloud
    # D2: phase 7p's paged gateway on the (1, 1) mesh, the same sequence
    t_ph = time.perf_counter()
    pgw, pprobe, pcloud, _ = c.gateway_from_weights(
        **c.tiers, safety=c.safety, router_cfg=c.gw.router_cfg,
        mesh=c.mesh11, engine_kw=dict(paged=True, pool_blocks=1024))
    check(pprobe.mesh is c.mesh11 and pprobe.paged,
          "D2 gateway: the tiers are not paged on the mesh")
    pgw.answer_batch(c.queries)                      # warm up, as phase 7p
    torch.cuda.synchronize()
    pgw.reset_fault_state()
    t0 = time.perf_counter()
    plog = c.counted("mesh11 paged gateway answer_batch", PAGED_KERNELS,
                     lambda: pgw.answer_batch(c.queries),
                     forbid=("decode_attention",))
    t_b = time.perf_counter() - t0
    check(np.array_equal(plog.decision, c.plog.decision)
          and np.array_equal(plog.u, c.plog.u)
          and np.array_equal(plog.answers, c.plog.answers)
          and pprobe.pool.live_sessions == 0,
          "D2 gateway: decisions, u or answers differ from phase 7p's, or "
          "the probe kept sessions")
    c.report["mesh_paged"]["gateway"] = {
        "answer_batch_s": t_b, "phase_s": time.perf_counter() - t_ph}
    print(f"[D2] paged gateway answer_batch on the (1, 1) mesh: {t_b:.3f} "
          "s, decisions, u and answers equal phase 7p's")
    del pgw, pprobe, pcloud
    torch.distributed.destroy_process_group()


def step_bytes(eng) -> int:
    """Bytes of weights one decode step reads: every parameter and buffer
    but an untied embedding table (a step reads B of its rows; a tied one
    is the head)."""
    skip = set() if eng.cfg.tie_embeddings else {id(eng.params.embed)}
    seen = {id(t): t for t in [*eng.params.parameters(),
                               *eng.params.buffers()] if id(t) not in skip}
    return sum(t.nbytes for t in seen.values())


def phase_q1(c):
    """Q1. quantized serving weights (``weight_quant``).  The reference's
    contract against the bf16 engine, 2 * max(budget, 0.01) (0.04 for
    attention models, ``tests/test_quantized.py``), is held tie-aware where
    the reference sets it: its smoke configs (``llama3-8b``,
    ``deepseek-moe-16b``) at the init scale, paged on an int8 pool, int8
    and fp8 weights.  At published widths (the probe, 30 layers, and
    ``llama3-8b``, 4 layers) the quantization noise of random full-width
    weights reads past that budget, so there each quantized engine is held
    to an engine over its dequantized weights (``quant.dequantize_params``:
    tie-aware, bitwise reported) and its distance to the bf16 engine is
    reported; the graph route bitwise the eager route; weight bytes on the
    card, decode ms/step and busy share beside the bf16 engine's and the
    bytes a step reads.  ``deepseek-moe-16b`` (2 layers, int8): gather
    decode against dispatch decode within 0.02.  The dequantization
    bitwise ``(q.float() * scale).to(bf16)`` on the card."""
    np, torch = c.np, c.torch
    t_ph = time.perf_counter()
    pr, mn = c.prompts, c.max_new
    TQ = c.TQ
    budget = 2 * max(0.02, 0.01)
    rep = {"budget": budget, "models": {}, "smoke": {}}
    g = torch.Generator(device=c.dev).manual_seed(SEED + 30)
    w = torch.randn((64, 512), generator=g, device=c.dev,
                    dtype=torch.bfloat16)
    for quant in ("int8", "fp8"):
        q, sc = TQ.quantize_rows(w, quant)
        check(torch.equal(TQ.dequantize_rows(q, sc, torch.bfloat16),
                          (q.float() * sc[:, None]).to(torch.bfloat16)),
              f"Q1: {quant} dequantization differs from (q.float() * "
              "scale).to(bf16) on the card")
    # the reference's budget at the reference's setting
    sp = np.array([[0, 3, 20, 195, 2], [3, 21, 196, 199, 2],
                   [0, 0, 7, 9, 2]], np.int32)
    for arch in ("llama3-8b", "deepseek-moe-16b"):
        sc_ = dataclasses.replace(c.configs.get_smoke(arch), vocab_size=512)
        sm = c.init_params(sc_, torch.Generator(device=c.dev).manual_seed(
            0), device=c.dev)
        kw = dict(paged=True, block_len=16)
        base = c.InferenceEngine("Q1-smoke", sc_, sm, c.ucfg, **kw)
        r0 = base.generate(sp, 6)
        for quant in ("int8", "fp8"):
            r1 = c.InferenceEngine("Q1-smoke-q", sc_, sm, c.ucfg,
                                   cache_quant="int8", weight_quant=quant,
                                   **kw).generate(sp, 6)
            # logits within the budget up to a flip, and a flip only where
            # the bf16 top-2 gap is within twice it (the init-scale
            # softmax over 512 tokens is near uniform: near ties)
            rep["smoke"][f"{arch} {quant}"] = list(tie_aware(
                f"Q1 {arch} smoke {quant} vs bf16", r1["tokens"],
                r0["tokens"], r0["logits"].float().cpu().numpy(),
                r1["logits"].float().cpu().numpy(), atol=budget))
        print(f"[Q1] {arch} smoke (vocabulary 512, init scale), paged, int8 "
              f"pool: int8/fp8 weights against bf16 weights tie-aware "
              f"within {budget}: "
              + ", ".join(f"{k.split()[-1]} reading {v[1]:.3f} ({v[0]} "
                          f"flips, logits {v[2]:.4f} apart)"
                          for k, v in rep["smoke"].items()
                          if k.startswith(arch)))
        del base, sm
    pools = {"mono": ({}, {}),
             "paged": (dict(paged=True, pool_blocks=256),
                       dict(paged=True, pool_blocks=256,
                            cache_quant="int8"))}
    for mi, (name, cfg_, model) in enumerate((
            ("smollm-135m", c.cfg, c.probe.params),
            ("llama3-8b 4 layers", c.lcfg, c.cloud.params))):
        m_rep = {}
        for li, (layout, (bkw, qkw)) in enumerate(pools.items()):
            mono = layout == "mono"
            needs = SERVE_KERNELS if mono else PAGED_SERVE
            forbid = (("paged_decode_attention",) if mono
                      else ("decode_attention",))
            base = c.InferenceEngine(f"Q1-{layout}-bf16", cfg_, model,
                                     c.ucfg, **bkw)
            ref = base.generate(pr, mn)
            ms_b = busy_b = None
            if mono:
                ms_b, _, busy_b, _ = c.decode_rate(base)
            l_rep = {"bf16": {"weight_bytes": base.weight_bytes(),
                              "step_bytes": step_bytes(base),
                              "ms_per_step": ms_b, "busy": busy_b}}
            for qi, quant in enumerate(("int8", "fp8")):
                eng = c.InferenceEngine(f"Q1-{layout}-{quant}", cfg_, model,
                                        c.ucfg, weight_quant=quant, **qkw)
                check(bool(TQ.quantized_names(eng.params))
                      and not TQ.quantized_names(model),
                      f"Q1 {name}: the engine's weights are not quantized "
                      "or the caller's model was")
                eng.generate(pr, mn)                  # capture
                res = c.counted(f"Q1 {name} {layout} {quant} generate",
                                needs, lambda: eng.generate(pr, mn),
                                forbid=forbid)
                lg = res["logits"].float().cpu().numpy()
                dist = tie_reading(res["tokens"], ref["tokens"],
                                   ref["logits"].float().cpu().numpy(), lg,
                                   atol=budget)
                q_rep = {"weight_bytes": eng.weight_bytes(),
                         "step_bytes": step_bytes(eng),
                         "to_bf16_at_budget": list(dist)}
                if mono:
                    # the same products over the dequantized weights
                    twin = c.InferenceEngine(
                        f"Q1-{quant}-twin", cfg_, TQ.dequantize_params(
                            eng.params, cfg_.dtype), c.ucfg)
                    twin._graphs = None
                    tr = twin.generate(pr, mn)
                    q_rep["dequantized_twin"] = list(tie_aware(
                        f"Q1 {name} {quant} vs its dequantized twin",
                        res["tokens"], tr["tokens"],
                        tr["logits"].float().cpu().numpy(), lg))
                    q_rep["twin_bitwise"] = bool(
                        np.array_equal(res["tokens"], tr["tokens"])
                        and torch.equal(res["logits"], tr["logits"]))
                    del twin, tr
                    ms, dms, busy, _ = c.decode_rate(eng)
                    q_rep.update(ms_per_step=ms, device_ms_per_step=dms,
                                 busy=busy)
                if (mi + li + qi) % 2 == 0:
                    # the graph route, bitwise the eager route
                    a = eng.generate(pr, mn, return_state=True)
                    b = c.eager_twin(eng, weight_quant=quant,
                                     **qkw).generate(pr, mn,
                                                     return_state=True)
                    c.bitwise(f"Q1 {name} {layout} {quant}", a, b)
                    eng.release(a["state"])
                    q_rep["graph_bitwise_eager"] = True
                l_rep[quant] = q_rep
                print(f"[Q1] {name} {layout} {quant}: weights "
                      f"{q_rep['weight_bytes'] / 1e9:.4f} GB (bf16 "
                      f"{base.weight_bytes() / 1e9:.4f}); a step reads "
                      f"{q_rep['step_bytes'] / 1e9:.4f} GB of weights (bf16 "
                      f"{step_bytes(base) / 1e9:.4f}, "
                      f"{step_bytes(base) / HBM_BPS * 1e3:.3f} ms at 3.35 "
                      "TB/s)"
                      + (f"; decode {q_rep['ms_per_step']:.3f} ms/step, "
                         f"busy {q_rep['busy'] or 0:.3f} (bf16 {ms_b:.3f}, "
                         f"busy {busy_b or 0:.3f}); dequantized twin "
                         f"tie-aware equal (bitwise: "
                         f"{q_rep['twin_bitwise']})" if mono else "")
                      + f"; to bf16 at the reference's {budget}: reading "
                      f"{dist[1]:.3f}, {dist[0]} rows flipped, logits "
                      f"{dist[2]:.4f} apart before a flip (reported)"
                      + ("; graph route bitwise the eager route"
                         if "graph_bitwise_eager" in q_rep else ""))
                del eng
            m_rep[layout] = l_rep
            del base
        rep["models"][name] = m_rep
        gc.collect()
        torch.cuda.empty_cache()
    # MoE gather decode against dispatch decode under int8 weights
    dc = dataclasses.replace(c.configs.get_config("deepseek-moe-16b"),
                             num_layers=2)
    dm = c.init_params(dc, torch.Generator(device=c.dev).manual_seed(
        SEED + 31), device=c.dev)
    disp = c.InferenceEngine("Q1-moe-dispatch", dc, dm, c.ucfg,
                             weight_quant="int8")
    gath = c.InferenceEngine("Q1-moe-gather", dataclasses.replace(
        dc, moe_decode_impl="gather"), dm, c.ucfg, weight_quant="int8")
    r0 = disp.generate(pr, mn)
    gath.generate(pr, mn)                             # capture
    r1 = c.counted("Q1 deepseek-moe-16b int8 gather decode", SERVE_KERNELS,
                   lambda: gath.generate(pr, mn),
                   forbid=("paged_decode_attention",))
    moe = tie_aware("Q1 deepseek-moe-16b int8: gather vs dispatch decode",
                    r1["tokens"], r0["tokens"],
                    r0["logits"].float().cpu().numpy(),
                    r1["logits"].float().cpu().numpy(), atol=0.02)
    rep["moe_gather_vs_dispatch"] = list(moe)
    rep["phase_s"] = time.perf_counter() - t_ph
    print(f"[Q1] deepseek-moe-16b 2 layers int8: gather decode vs dispatch "
          f"decode tie-aware within 0.02 (logits {moe[2]:.4f} apart, "
          f"{moe[0]} flips, reading {moe[1]:.3f}); phase "
          f"{rep['phase_s']:.1f} s")
    c.report["weight_quant"] = rep
    del disp, gath, dm
    gc.collect()
    torch.cuda.empty_cache()


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
        from repro_torch.launch import train as train_mod
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

    def time_ms(fn, iters=20, spin=5_000_000):
        """Median device time of one call with a cold L2: a spin kernel of
        ``spin`` cycles keeps the stream busy while the host enqueues the
        call (a call of many kernels needs a longer one)."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(spin)
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

    def flash_case(label, B, S, H, K, D, n_pad, main=False, window=None):
        q, k, v = randn(B, S, H, D), randn(B, S, K, D), randn(B, S, K, D)
        pos = (torch.arange(S, device=dev, dtype=torch.int32) - n_pad)
        kw = dict(q_positions=pos, kv_positions=pos, window=window)
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
        if window is not None:
            mask &= qp - kp < window
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

    def grid_case(label, B, S, H, K, D, causal, window=None, main=False,
                  dtype=torch.bfloat16):
        """Row 4, the grid-offset op: masks from query row / key column;
        bf16 (the tensor-core body) or f32 (the CUDA-core body)."""
        q, k, v = (randn(B, S, H, D, dtype=dtype),
                   randn(B, S, K, D, dtype=dtype),
                   randn(B, S, K, D, dtype=dtype))
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
        nbytes = q.element_size() * (2 * B * S * H * D + 2 * B * S * K * D)
        nops = 4 * D * n_valid * H * B
        b_ms, b_by = bound(nbytes, nops, BF16_FLOPS if dtype == torch.bfloat16
                           else F32_FLOPS)
        ms = time_ms(lambda: fops.flash_attention(q, k, v, **kw))
        return dict(name="flash_attention", label=label, main=main,
                    max_abs_err=err, tol=2e-2, ms=ms, tflops=nops / ms / 1e9,
                    plain_ms=time_ms(lambda: fref.flash_attention_ref(
                        q, k, v, **kw)),
                    library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)

    def decode_case(label, B, T, K, G, D, main=False, fill=None,
                    window=None):
        """Row 2 over a T-slot cache: slots 0..index hold their positions,
        the rest are empty (-1), row 0 sees no key.  The index is drawn
        from [T/2, T), or with ``fill`` = (n_pad, lo, hi) from [lo, hi)
        with the first n_pad slots padding (-1): the gateway's cache at a
        decode step.  With ``window`` (= T) the cache is a ring that has
        wrapped: the index is drawn from [T, 2T) and slot s holds the
        latest position p <= index with p % T == s."""
        q, k, v = randn(B, K, G, D), randn(B, T, K, D), randn(B, T, K, D)
        lo, hi = ((T // 2, T) if fill is None else fill[1:]) if window is \
            None else (T, 2 * T)
        idx = torch.randint(lo, hi, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        ar = torch.arange(T, device=dev, dtype=torch.int32)
        if window is None:
            pos = torch.where(ar[None] <= idx[:, None], ar[None], -1)
        else:
            pos = ar[None] + T * torch.div(idx[:, None] - ar[None], T,
                                           rounding_mode="floor")
        pos = pos.to(torch.int32).contiguous()
        if fill is not None:
            pos[:, :fill[0]] = -1                    # bucket padding
        pos[0] = -1                                  # a row with no valid slot
        kw = dict(window=window)
        out = dops.decode_attention(q, k, v, pos, idx, **kw)
        ref = dref.decode_attention_ref(q, k, v, pos, idx, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        valid = (pos >= 0) & (pos <= idx[:, None])
        if window is not None:
            valid &= idx[:, None] - pos < window
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
                                                             idx, **kw)),
                    plain_ms=time_ms(lambda: dref.decode_attention_ref(
                        q, k, v, pos, idx, **kw)),
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
        # row 5 at D2's rank-local shapes (its rank jobs, ``D2_JOBS``):
        # each rank's share of phase 4's 8 rows and of the pool's blocks
        # over 'data', its KV heads over 'model' (the probe on (2, 1): 4
        # rows, 3 KV heads; llama3-8b on (1, 2): 8 rows, 4 of the 8 KV
        # heads, an int8 pool); a 200-token prompt's 256-slot bucket and
        # 16 new tokens, 320 slots in 5 blocks of 64, the last step
        *(paged_case(f"D2 rank {arch} ({2 // mp}, {mp}) {kw.get('cache_quant') or 'bf16'} "
                     f"pool B{8 * mp // 2} K{dc.num_kv_heads // mp} "
                     f"G{dc.num_heads // dc.num_kv_heads} D{dc.head_dim} "
                     f"N{kw['pool_blocks'] * mp // 2} nb5 S{mn}", 8 * mp // 2,
                     dc.num_kv_heads // mp, dc.num_heads // dc.num_kv_heads,
                     dc.head_dim, nb=5, S=mn, p0=256,
                     N=kw["pool_blocks"] * mp // 2,
                     quant=kw.get("cache_quant"))
          for arch, _, mp, mn, kw in D2_JOBS
          for dc in (configs.get_config(arch),)),
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
        # R0: the recurrent families' shapes.  recurrentgemma-2b: head_dim
        # 256, 10 query heads on 1 KV head, windowed (2048) ring layers,
        # vocabulary 256000; mamba2-780m: no attention, vocabulary 50280
        flash_case("R0 recurrentgemma prefill B8 S256 D256 G10", 8, 256,
                   10, 1, 256, 56, window=2048),
        flash_case("R0 recurrentgemma prefill B2 S4096 D256 G10 past the "
                   "window 2048", 2, 4096, 10, 1, 256, 1796, window=2048),
        decode_case("R0 recurrentgemma decode B8 T320 D256 G10", 8, 320, 1,
                    10, 256),
        decode_case("R0 recurrentgemma decode B8 ring T2048 D256 G10", 8,
                    2048, 1, 10, 256, fill=(0, 1000, 2048)),
        decode_case("R0 recurrentgemma decode B2 ring T2048 D256 G10 "
                    "wrapped", 2, 2048, 1, 10, 256, window=2048),
        *(paged_case(f"R0 paged recurrentgemma ring window 2048 {qm or 'bf16'}"
                     f" pool B8 L64 nb32 S8 D256 G10", 8, 1, 10, 256, nb=32,
                     p0=2300, window=2048, quant=qm)
          for qm in (None, "int8")),
        paged_case("R0 paged recurrentgemma B8 L64 nb5 S8 D256 G10", 8, 1,
                   10, 256, nb=5, p0=248),
        uncertainty_case("R0 recurrentgemma B8 V256000", 8, 256000),
        uncertainty_case("R0 mamba2 B8 V50280", 8, 50280),
    ]
    def hold_cases(tag, cases):
        """Each case within its tolerance of the plain version; printed
        beside its plain, library and bound times, and kept for the
        ``kernels`` line."""
        for c in cases:
            check(c["max_abs_err"] <= c["tol"],
                  f"{c['label']}: error {c['max_abs_err']} > {c['tol']}")
            lib = ("-" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f}")
            rel = (f", h relative {c['h_rel_err']:.2e} (rtol 1e-4)"
                   if "h_rel_err" in c else "")
            rate = (f" ({c['tflops']:.1f} TFLOP/s)" if "tflops" in c
                    else "")
            split = (f", {c['splits']} splits of {c['chunk']}"
                     if "splits" in c else "")
            print(f"[{tag}] {c['label']}: err {c['max_abs_err']:.2e} (tol "
                  f"{c['tol']:g}{rel}) kernel {c['ms']:.4f} ms{rate} plain "
                  f"{c['plain_ms']:.4f} ms library {lib} ms bound "
                  f"{c['bound_ms']:.5f} ms ({c['bound_by']}){split}")
            checks.append(c)

    hold_cases("3", cases)
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
    path_seconds: dict[str, float] = {}

    def counted(path, needs, fn, forbid=()):
        """Run one path with every kernel count set to 0 just before it and
        read just after: each kernel the path runs (``needs``) must have
        launched, none of ``forbid`` may have, and no plain version may
        have run."""
        for c in counts_of.values():
            c.reset()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        path_seconds[path] = time.perf_counter() - t
        got = {n: c.launches for n, c in counts_of.items()}
        for n in needs:
            check(got[n] > 0, f"{path}: {n} was never launched")
        for n in forbid:
            check(got[n] == 0, f"{path}: {n} launched {got[n]} times")
        for n, c in counts_of.items():
            check(c.plain == 0, f"{path}: {c.plain} calls of {n}'s plain "
                                "version")
        path_launches[path] = got
        print(f"[k] {path}: launches {got} ({path_seconds[path]:.2f} s; "
              f"{time.perf_counter() - T_START:.0f} s into the script)")
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

    PROF_STEPS = 4

    def decode_rate(eng, pr=None, steps=None):
        """Decode ms/step of ``eng`` on the prompts ``pr`` (phase 4's by
        default, B=8) with no prefill in the window: a ``steps``-token
        (``max_new``) extension of a fresh 1-token session, timed
        unprofiled, then a ``PROF_STEPS``-token one profiled for its device
        kernel time per step (a share well below 1 means the host holds the
        card; the profile parses at ~1 ms an event, so a 32-step graph of
        ~24k kernels took ~25 s).  Returns (wall ms/step, device ms/step,
        busy share or None, the profile's top kernels over PROF_STEPS
        steps)."""
        pr = prompts if pr is None else pr
        steps = max_new if steps is None else steps

        def session():
            st = eng.generate(pr, 1, return_state=True)["state"]
            torch.cuda.synchronize()
            return st
        ext = eng.generate(None, steps, state=session(), return_state=True)
        eng.release(ext["state"])                       # warm up, capture
        st = session()
        t0 = time.perf_counter()
        ext = eng.generate(None, steps, state=st, return_state=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        eng.release(ext["state"])
        ps = min(PROF_STEPS, steps)
        ext = eng.generate(None, ps, state=session(), return_state=True)
        eng.release(ext["state"])                       # capture
        st = session()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            ext = eng.generate(None, ps, state=st, return_state=True)
            torch.cuda.synchronize()
        eng.release(ext["state"])
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in ka) / ps / 1e3
        top = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in ka), reverse=True)[:6]
        return ms, dev_ms, (dev_ms / ms if dev_ms > 0 else None), top

    # warm up cuBLAS et al. and capture the graphs the timed calls replay
    # (a capture is not a dispatch)
    for n in (1, max_new):
        probe.generate(prompts, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = counted("smollm generate", SERVE_KERNELS,
                  lambda: probe.generate(prompts, max_new),
                  forbid=("paged_decode_attention",))
    t_gen = time.perf_counter() - t0
    per_tok, step_dev_ms, busy, top = decode_rate(probe)
    t_prefill = t_gen - max_new * per_tok / 1e3
    toks, u = res["tokens"], res["u"]
    logits = res["logits"].float().cpu().numpy()
    check(toks.shape == (8, max_new) and toks.min() >= 0 and toks.max() < V,
          "generate tokens out of range")
    check(bool(np.isfinite(logits).all()), "generate logits not finite")
    check(bool(np.isfinite(u).all() and (u >= 0).all() and (u <= 1).all()),
          f"u outside [0, 1]: {u}")
    print(f"[4] generate B=8 S={S} max_new={max_new}: {t_gen * 1e3:.1f} ms, "
          f"of which prefill ~{t_prefill * 1e3:.1f} ms; decode "
          f"{per_tok:.2f} ms/step (a decode-only extension), "
          f"{8 * max_new / t_gen:.1f} tokens/s end to end")
    print(f"[4] decode step: device kernel time {step_dev_ms:.3f} ms of "
          f"{per_tok:.2f} ms wall (busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'})")
    for us, key, n in top:
        print(f"[4]   {PROF_STEPS}-step extension: {us / 1e3:9.3f} ms in "
              f"{n:5d} x {key[:70]}")

    def serve8():
        return probe.serve(
            [Request(rid=i, prompt=prompts[i].tolist(), max_new=max_new)
             for i in range(8)], n_slots=4, decode_chunk=8)
    serve8()                                        # capture its chunk
    t0 = time.perf_counter()
    fin = counted("smollm serve", SERVE_KERNELS, serve8)
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
        "prefill_ms": t_prefill * 1e3, "decode_ms_per_step": per_tok,
        "generate_s": t_gen, "tokens_per_s": 8 * max_new / t_gen,
        "decode_step_device_ms": step_dev_ms, "decode_busy_share": busy,
        "profile_top_extension": [(us / 1e3, key, n) for us, key, n in top],
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
        eng.generate(prompts, max_new)              # warm up, capture
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
    cloud.generate(lp, 16)                          # warm up, capture
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

    # ---- 4g. one graph replay per decode dispatch ----------------------
    # every engine above decodes through captured CUDA graphs (its
    # default on the card); here each route is held bitwise to the eager
    # loop, the oracle (``_graphs = None``), on the same weights: tokens,
    # logits, the Eq. 2-3 means, the returned state (a monolithic one's
    # cache too) and a paged engine's served pool blocks; then timed
    def eager_twin(eng, **kw):
        o = InferenceEngine(eng.name + "-eager", eng.cfg, eng.params,
                            eng.ucfg, **kw)
        o._graphs = None
        return o

    def state_tensors(st):
        ts = [st.pos, st.cur, st.last]
        if isinstance(st.cache, list):
            ts += [t for c in st.cache for t in c]
        return ts

    def bitwise(label, a, b):
        same = (np.array_equal(a["tokens"], b["tokens"])
                and torch.equal(a["logits"], b["logits"])
                and all(np.array_equal(a[k], b[k])
                        for k in ("u", "h_mean", "v_mean")))
        if "state" in a:
            same = same and all(torch.equal(x, y) for x, y in zip(
                state_tensors(a["state"]), state_tensors(b["state"])))
        check(same, f"4g: {label}: the graph route differs from the eager "
                    "loop")

    def served(eng, pool):
        """A pool's served blocks, or its state rows without the sink."""
        if isinstance(pool, attention.KVPool):
            return pool.served()
        return [t[:eng.pool.n_rows] for t in pool]

    def pools_bitwise(label, a, b):
        check(all(torch.equal(x, y)
                  for pa, pb in zip(a.pool.arrays, b.pool.arrays)
                  for x, y in zip(served(a, pa), served(b, pb))
                  if x is not None),
              f"4g: {label}: the pools differ after the graph route")

    def session_bitwise(label, g, e, pr, n, greedy=True, pools=False,
                        span=None):
        """generate(return_state), with ``span`` a warm continuation of it,
        then an _extend of 8, graph vs eager."""
        a = g.generate(pr, n, greedy=greedy, seed=0, return_state=True)
        b = e.generate(pr, n, greedy=greedy, seed=0, return_state=True)
        bitwise(label, a, b)
        if span is not None:
            a = g.generate(span, n, state=a["state"], greedy=greedy, seed=1,
                           return_state=True)
            b = e.generate(span, n, state=b["state"], greedy=greedy, seed=1,
                           return_state=True)
            bitwise(label + " + continuation", a, b)
        a2 = g.generate(None, 8, state=a["state"], greedy=greedy,
                        return_state=True)
        b2 = e.generate(None, 8, state=b["state"], greedy=greedy,
                        return_state=True)
        bitwise(label + " + _extend 8", a2, b2)
        if pools:
            pools_bitwise(label, g, e)
            for eng, st in ((g, a2["state"]), (e, b2["state"])):
                eng.release(st)
        print(f"[4g] {label}: bitwise the eager route ("
              + ("its continuation, " if span is not None else "")
              + "its _extend)")
        return a["state"].max_len

    t_phase = time.perf_counter()
    oracle = eager_twin(probe)
    # each generate with a warm continuation of 12 tokens: both are one
    # replay of a whole-generation graph (F1 profiles them)
    span = np.random.default_rng(SEED + 7).integers(
        1, V, (8, 12)).astype(np.int32)
    t_cache = session_bitwise("smollm generate", probe, oracle, prompts,
                              max_new, span=span)
    session_bitwise("smollm sampled generate (seed 0)", probe, oracle,
                    prompts, max_new, greedy=False, span=span)
    paged4g = {}
    for impl in ("kernel", "gather"):
        g = paged_engine(f"probe-{impl}", attn_decode_impl=impl)
        tw = eager_twin(g, paged=True, pool_blocks=256,
                        attn_decode_impl=impl)
        session_bitwise(f"paged smollm generate ({impl})", g, tw, prompts,
                        max_new, pools=True, span=span)
        if impl == "kernel":
            session_bitwise(f"paged smollm sampled generate ({impl})", g,
                            tw, prompts, max_new, greedy=False, pools=True,
                            span=span)
        paged4g[impl] = g
        del g, tw
    session_bitwise("llama3-8b 4 layers generate", cloud,
                    eager_twin(cloud), lp, 16)
    fins = []
    for eng in (probe, oracle):
        fins.append(sorted(eng.serve(
            [Request(rid=i, prompt=prompts[i].tolist(), max_new=max_new)
             for i in range(8)], n_slots=4, decode_chunk=8),
            key=lambda r: r["rid"]))
    check(all(np.array_equal(a["tokens"], b["tokens"]) and a["u"] == b["u"]
              for a, b in zip(*fins)),
          "4g: serve through graphs differs from the eager loop")
    print("[4g] smollm serve: bitwise the eager loop")

    # decode ms/step and busy share, eager and graph in turns
    # (``decode_rate``: a decode-only extension, no prefill in the window)
    turns = []
    for name, eng in (("eager", oracle), ("graph", probe)):
        ms, dev_ms, busy_g, _ = decode_rate(eng)
        turns.append({"route": name, "ms_per_step": ms,
                      "device_ms_per_step": dev_ms, "busy_share": busy_g})
        print(f"[4g] decode B=8 ({name}): {ms:.3f} ms/step, device "
              f"{dev_ms:.3f} ms/step, busy share "
              f"{'not measured' if busy_g is None else f'{busy_g:.3f}'}")
    gs = dict(probe._graphs.stats)
    io_b = 2 * sum(t.nbytes for t in state_tensors(
        probe.generate(prompts, 1, return_state=True)["state"])[3:])
    print(f"[4g] probe graphs: {len(probe._graphs)} held, "
          f"{gs['captures']} captures in {gs['capture_s']:.2f} s "
          f"({gs['capture_s'] / max(gs['captures'], 1):.3f} s each), "
          f"{gs['pool_bytes'] / 1e6:.1f} MB kept by captures (outputs), "
          f"{gs['replays']} replays, arena copy in+out {io_b / 1e6:.1f} MB "
          f"a dispatch at a {t_cache}-slot cache; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    report["graphs"] = {"turns": turns, "probe_stats": gs,
                        "probe_graphs_held": len(probe._graphs),
                        "arena_io_bytes_per_dispatch": io_b,
                        "cache_len": t_cache}
    del oracle

    ctx = SimpleNamespace(
        np=np, torch=torch, dev=dev, cfg=cfg, ucfg=ucfg, probe=probe,
        prompts=prompts, max_new=max_new, span=span, paged4g=paged4g,
        lcfg=lcfg, cloud=cloud,
        counted=counted, decode_rate=decode_rate, eager_twin=eager_twin,
        bitwise=bitwise, pools_bitwise=pools_bitwise,
        InferenceEngine=InferenceEngine, configs=configs,
        init_params=init_params, TQ=TQ, report=report)
    # ---- F1. whole generation in one device call -------------------------
    phase_f1(ctx)
    # ---- Q1. quantized serving weights -----------------------------------
    phase_q1(ctx)
    # ---- D1. serving on a (data, model) mesh -----------------------------
    phase_d1(ctx)
    # ---- D2. the paged pool and quantized weights on a mesh --------------
    phase_d2(ctx)
    # ---- D3. the recurrent mixers and MoE on a mesh: the two ranks -------
    phase_d3(ctx)
    mesh11 = ctx.mesh11
    ctx_t4 = ctx.t4
    del ctx, paged4g

    # ---- 4f. serve() under injected faults, at the probe's full width ---
    # famine for two admission rounds, one forced eviction of a warm
    # handle (cold re-prefill from cold_prompt), two slot failures
    # (requeue), a 10 s decode straggle on a 1 ms/step clock that expires
    # the one request with a deadline; on a paged probe through row 5
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    fprobe = paged_engine("probe-faults")
    sys_p = prompts[0:1, S - lens[0]:]
    span = rng.integers(1, V, 12).astype(np.int32)
    warm = fprobe.absorb(sys_p)
    cold_full = np.concatenate([sys_p[0], span])
    plan = FaultPlan([FaultEvent("pool", "famine", count=2),
                      FaultEvent("session", "evict"),
                      FaultEvent("slot", "fail", count=2),
                      FaultEvent("decode", "straggle", delay_s=10.0)])
    freqs = ([Request(rid=i, prompt=prompts[i].tolist(), max_new=max_new)
              for i in range(8)]
             + [Request(rid=8, prompt=span.tolist(), state=warm,
                        cold_prompt=cold_full.tolist(), max_new=16),
                Request(rid=9, prompt=prompts[1].tolist(), max_new=max_new,
                        deadline_ms=5000.0)])
    c0 = dict(fprobe.counters)
    t0 = time.perf_counter()
    ffin = counted("paged serve under faults", PAGED_SERVE,
                   lambda: fprobe.serve(freqs, n_slots=4, decode_chunk=8,
                                        faults=plan, step_time_ms=1.0),
                   forbid=("decode_attention",))
    t_fault = time.perf_counter() - t0
    dc = {k: fprobe.counters[k] - c0[k] for k in (
        "famine_deferred", "requeued", "reprefill_cold", "expired", "shed")}
    byrid = {r["rid"]: r for r in ffin}
    check(sorted(byrid) == list(range(10)), f"4f: requests lost: "
                                            f"{sorted(byrid)}")
    check(byrid[9].get("shed") and not any(
        byrid[i].get("shed") for i in range(9)),
        "4f: the expired request is not shed, or another one is")
    check(dc["requeued"] == 2 and dc["reprefill_cold"] == 1
          and dc["expired"] == 1 and dc["famine_deferred"] > 0,
          f"4f: fault counters {dc}")
    f_read = tie_aware("4f: faulted serve vs generate",
                       [byrid[i]["tokens"] for i in range(8)], toks, logits)
    cref = probe.generate(cold_full[None], 16)
    w_read = tie_aware("4f: evicted warm request vs a cold generate",
                       byrid[8]["tokens"][None], cref["tokens"],
                       cref["logits"].float().cpu().numpy())
    check(fprobe.pool.live_sessions == 0, "4f: a handle outlived serve()")
    print(f"[4f] serve of 10 requests under {plan.counters}: {t_fault:.2f} "
          f"s, counters {dc}; every request retired, rid 9 expired shed; "
          f"tie-aware equal to generate ({f_read[0]} rows diverged at a "
          f"tie; evicted warm request {w_read[0]})")
    report["faults"] = {"serve_s": t_fault, "counters": dc,
                        "plan": dict(plan.counters),
                        "tie": list(f_read), "warm_tie": list(w_read)}
    del fprobe

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
        # the wrong paths patch the model's Python, which a replay of an
        # already captured graph would not run: they decode eagerly
        graphed, engine._graphs = engine._graphs, None
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
        engine._graphs = graphed
        return sound, wrong

    calib = {}
    for label, engine, n_layers, plen, steps in (
            ("smollm-135m", probe, cfg.num_layers, 40, 24),
            ("llama3-8b 4 layers", cloud, lcfg.num_layers, 40, 16)):
        sound, wrong = readings(engine, n_layers, plen, steps, range(2))
        calib[label] = {"sound": sound, "wrong": wrong}
        print(f"[6] {label}: stepwise vs generate over 2 prompt seeds: "
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

    def captures(engines):
        return sum(e._graphs.stats["captures"] for e in engines)

    def timed_again(g):
        """A second batch from the same fresh state: host time varies."""
        g.reset_fault_state()
        torch.cuda.synchronize()
        t = time.perf_counter()
        g.answer_batch(queries)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def held(engines):
        return sum(len(e._graphs) for e in engines)

    n_cap0 = captures(members + [gcloud])
    t0 = time.perf_counter()
    gw.answer_batch(queries)                     # warm up every tier
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    n_first = captures(members + [gcloud]) - n_cap0
    gw.reset_fault_state()
    n_cap = captures(members + [gcloud])
    before = dict(gprobe.counters)
    with timed_tiers(members + [gcloud]):
        t0 = time.perf_counter()
        log = counted("gateway answer_batch", MONO_KERNELS,
                      lambda: gw.answer_batch(queries),
                      forbid=("paged_decode_attention",))
        t_batch = time.perf_counter() - t0
    batch_tiers = dict(tier_s)
    n_cap = captures(members + [gcloud]) - n_cap
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
    t_batch2 = timed_again(gw)
    print(f"[7] answer_batch on {len(queries)} queries: {t_batch:.3f} s "
          f"(again: {t_batch2:.3f} s; {n_cap} graph captures in the counted "
          f"batch; the first batch {t_first:.3f} s with {n_first} captures; "
          f"{held(members + [gcloud])} graphs held); routes {routes}; tiers "
          + ", ".join(
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
        "answer_batch_s": t_batch, "answer_batch_again_s": t_batch2,
        "captures_in_batch": n_cap, "first_batch_s": t_first,
        "first_batch_captures": n_first,
        "graphs_held": held(members + [gcloud]), "tier_s": batch_tiers,
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
    n_pcap0 = captures(pmembers + [pgcloud])
    t0 = time.perf_counter()
    pgw.answer_batch(queries)                    # warm up, as phase 7
    torch.cuda.synchronize()
    t_pfirst = time.perf_counter() - t0
    n_pfirst = captures(pmembers + [pgcloud]) - n_pcap0
    check(pgprobe.pool.blocks_in_use == p_base,
          "7p: the probe's pool kept blocks after a batch")
    pgw.reset_fault_state()
    n_pcap = captures(pmembers + [pgcloud])
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
    n_pcap = captures(pmembers + [pgcloud]) - n_pcap
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
    t_pbatch2 = timed_again(pgw)
    # 21 batches: the pool returns to its blocks after each, and the
    # batches after the first pay no capture
    n21 = captures(pmembers + [pgcloud])
    t0 = time.perf_counter()
    for _ in range(21):
        pgw.answer_batch(queries)
        check(pgprobe.pool.blocks_in_use == p_base,
              "7p: the probe's pool kept blocks after a batch")
    torch.cuda.synchronize()
    t_p21 = time.perf_counter() - t0
    n21 = captures(pmembers + [pgcloud]) - n21
    in_use = {e.name: e.pool.blocks_in_use for e in pmembers + [pgcloud]}
    print(f"[7p] paged gateway ({pool_gb:.2f} GB of pools): answer_batch "
          f"{t_pbatch:.3f} s (again: {t_pbatch2:.3f} s; {n_pcap} graph "
          f"captures in the counted batch; the first batch {t_pfirst:.3f} "
          f"s with {n_pfirst} captures; 21 more batches {t_p21:.2f} s with "
          f"{n21} captures; {held(pmembers + [pgcloud])} graphs held; "
          f"monolithic {t_batch:.3f} s); "
          f"routes {proutes} "
          f"({len(moved)} moved); max |u_paged - u_mono| {du.max():.3e}; s "
          f"identical; {n_ans} routed-alike answers differ ({flipped} tier "
          f"rows diverged at a tie); tiers " + ", ".join(
              f"{n} {t:.3f} s ({pk5.get(n, 0)} row-5 launches)"
              for n, t in pbatch_tiers.items()) + f"; blocks in use {in_use}")
    report["paged_gateway"] = {
        "pool_gb": pool_gb, "answer_batch_s": t_pbatch,
        "answer_batch_again_s": t_pbatch2, "captures_in_batch": n_pcap,
        "first_batch_s": t_pfirst, "first_batch_captures": n_pfirst,
        "batches_21_s": t_p21, "batches_21_captures": n21,
        "graphs_held": held(pmembers + [pgcloud]),
        "mono_answer_batch_s": t_batch, "tier_s": pbatch_tiers,
        "tier_row5_launches": pk5, "routes": proutes,
        "moved": moved.tolist(), "max_du": float(du.max()),
        "routed_alike_answers_differ": n_ans,
        "tier_tie_readings": {k: list(v) for k, v in tier_read.items()},
        "blocks_in_use": in_use}
    del pgw, pgprobe, pgcloud, pmembers
    # ---- D1, D2 (gateway). phases 7 and 7p on the (1, 1) mesh ------------
    phase_d1_gateway(SimpleNamespace(
        np=np, torch=torch, gateway_from_weights=gateway_from_weights,
        tiers=tiers, safety=(scfg, sparams), gw=gw, mesh11=mesh11,
        queries=queries, counted=counted, log=log, plog=plog_gw,
        report=report))
    del mesh11

    # ---- 8. the full-sequence forward: kernel vs plain version ---------
    @contextlib.contextmanager
    def swapped(mod, name, fn):
        """``mod.name`` replaced by ``fn`` for the block."""
        orig = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, orig)

    def forward_held(tag, m, c, batch, label, hold=True):
        """``forward`` through row 4 against the same forward with its
        plain version swapped in: one grid launch per layer, finite logits
        within the tie budget (``hold=False``: the distance reported, for
        bf16 at a depth where the kernel's bf16 P and the plain version's
        f32 P drift apart by more than the budget, or where an ulp flips a
        near-tie MoE route); the MoE layers' aux loss finite."""
        path = f"{tag} {label}"
        with torch.inference_mode():
            t0 = time.perf_counter()
            fk, aux = counted(path, ("flash_attention",),
                              lambda: transformer.forward(m, c, batch))
            t_f = time.perf_counter() - t0
            with swapped(attention, "flash_attention",
                         fref.flash_attention_ref):
                fp, _ = transformer.forward(m, c, batch)
        check(path_launches[path]["flash_attention"] == c.num_layers,
              f"{path}: not one grid launch per layer")
        fk, fp = fk.float(), fp.float()
        check(bool(torch.isfinite(fk).all()) and math.isfinite(float(aux)),
              f"{path}: non-finite logits or aux {float(aux)}")
        atol = max(TIE_ATOL, TIE_ULPS * bf16_ulp(float(fp.abs().max())))
        diff = float((fk - fp).abs().max())
        agree = float((fk.argmax(-1) == fp.argmax(-1)).float().mean())
        within = float(((fk - fp).abs().amax(-1) <= atol).float().mean())
        if hold:
            check(diff <= atol, f"{path}: kernel and plain logits differ by "
                                f"{diff} > {atol}")
        print(f"[{tag}] {label}: {t_f * 1e3:.1f} ms, logits "
              f"{tuple(fk.shape)} {diff:.4f} apart (budget {atol:.4f}"
              f"{'' if hold else ', reported'}), {within:.4f} of positions "
              f"within it, argmax agreement {agree:.4f}")
        return {"max_dlogit": diff, "atol": atol, "argmax_agreement": agree,
                "share_within": within, "seconds": t_f, "held": hold,
                "aux": float(aux)}

    pcfg, pmodel = tiers["probe"]
    ftok = torch.randint(1, pcfg.vocab_size, (8, 256), generator=gen,
                         device=dev, dtype=torch.int32)
    report["forward"] = forward_held("8", pmodel, pcfg, {"tokens": ftok},
                                     "smollm forward B=8 S=256")
    del tiers, gw, gprobe, gcloud, pmodel, sparams, members, eng, mono_e, \
        pag_e, ftok
    gc.collect()
    torch.cuda.empty_cache()

    # ---- R1 / R1p / R2. the recurrent families at published widths ------
    # recurrentgemma-2b (5 of its 26 layers: rglru, rglru, attn_local +
    # 2 rglru, cut to keep the script inside its time;
    # head_dim 256, 10 query heads on 1 KV head, window 2048,
    # vocabulary 256000), and mamba2-780m (4 of its 48 SSD layers, no
    # attention, vocabulary 50280, cut to keep the script inside its
    # time), random weights from torch.Generator seeds
    from repro_torch.serving.swarm import SwarmExecutor
    ATTN_KERNELS = ("flash_attention_positions", "decode_attention",
                    "paged_decode_attention", "flash_attention")
    # D3 (1, 1): each recurrent and MoE phase's served engine against the
    # same engine on the (1, 1) NCCL mesh (phase 7's gateway check ended
    # D1's world; D3 starts one of its own and ends it after M2)
    d3_rep = {"mesh11": {}}
    d3c = SimpleNamespace(np=np, torch=torch, prompts=prompts,
                          counted=counted)

    def d3_mesh11(label, base, kw, needs, forbid):
        """D3 on the (1, 1) mesh: ``base`` (a phase's single-device engine,
        built with ``kw``) and an engine on the same weights on the (1, 1)
        NCCL mesh: ``generate`` on phase 4's prompts (16 tokens) bitwise,
        one graph launch, no collective (``mesh11_generate``)."""
        from repro_torch.launch.mesh import serving_mesh
        t0 = time.perf_counter()
        if "mesh" not in d3_rep:
            d3_rep["mesh"] = serving_mesh(device=dev)
        me = InferenceEngine(base.name + "-mesh11", base.cfg, base.params,
                             base.ucfg, mesh=d3_rep["mesh"], **kw)
        check(not me._state_cut and me._mcfg == base.cfg,
              f"D3 {label}: the (1, 1) mesh cut the model")
        d3_rep["mesh11"][label] = mesh11_generate(
            d3c, "D3", f"D3 {label}", base, me, 16, needs, forbid)
        del me
        gc.collect()
        torch.cuda.empty_cache()
        d3_rep["mesh11"][label]["seconds"] = time.perf_counter() - t0
    RPOOL = dict(paged=True, block_len=64, pool_blocks=1024, pool_rows=40)
    recurrent_rep: dict = {}

    def pool_idle(label, eng):
        check(eng.pool.blocks_in_use == 0 and eng.pool.rows_in_use == 0
              and eng.pool.live_sessions == 0,
              f"{label}: the pool holds {eng.pool.blocks_in_use} blocks, "
              f"{eng.pool.rows_in_use} rows, {eng.pool.live_sessions} "
              "sessions after the path")

    def wrong_path(tag, e, pr, label, patch):
        """A wrong path (``patch`` swaps a function in for a run of the
        eager loop, which a replay could not see) must read outside the
        f32 tie budget against the sound engine's ``generate``."""
        ref = e.generate(pr, 32)
        with patch():
            bad = eager_twin(e).generate(pr, 32)
        r = tie_reading(bad["tokens"], ref["tokens"],
                        ref["logits"].float().cpu().numpy(),
                        bad["logits"].float().cpu().numpy())
        check(r[1] > 1.0, f"{tag}: {label} reads only {r[1]:.3f} of the f32 "
                          "tie budget")
        print(f"[{tag}] f32 wrong path ({label}): reading {r[1]:.3f} "
              f"({r[2]:.4f} apart before a flip)")
        return list(r)

    def f32_copy(m, c):
        """An f32 model for config ``c`` holding ``m``'s weights by name (its
        first ``c.num_layers`` layers)."""
        mf = transformer.Transformer(c, device=dev)
        src = dict(m.named_parameters())
        with torch.no_grad():
            for n, a in mf.named_parameters():
                a.copy_(src[n])        # converts on the copy: no f32 temporary
        return mf

    def model_phase(tag, arch, seed, mono_needs, paged_needs, *,
                    layers=None, f32_layers=None, scale=6.0,
                    prompts_in=None, pool=RPOOL, warm=False,
                    f32_graph_layers=None):
        """A model at published widths (cut to ``layers``) through every
        path.  The bf16 model serves (kernel launches, times, the graph
        route bitwise the eager loop, monolithic and paged); an f32 copy of
        the same weights (its first ``f32_layers`` layers) holds the
        contracts tie-aware (generate = stepwise = serve, paged =
        monolithic, fan-out = cold concatenation, serve on a handle = its
        extension), because bf16 noise alone (another batch shape) moves
        these models' logits past the tie budget; the bf16 readings of the
        same pairs are reported beside that noise floor.  The pool is back
        at its blocks and rows after every path.  ``warm``: the bitwise
        check of the graph route takes a warm continuation too;
        ``f32_graph_layers``: an f32 copy of that many layers runs the
        graph route (cold and warm ``generate``, monolithic and paged)
        bitwise its eager route."""
        t_ph = time.perf_counter()
        # the earlier phases' freed blocks back to the card: the models
        # below take most of it, and captures' private pools cannot reuse
        # cached blocks
        gc.collect()
        torch.cuda.empty_cache()
        rc = configs.get_config(arch)
        if layers is not None:
            rc = dataclasses.replace(rc, num_layers=layers)
        rm = init_params(rc, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
        # the recurrent families: every matrix but the embedding and the
        # convs scaled by 6: at the init scale the tied logits are the last
        # token's embedding and a decode that drops its state or its K/V
        # reads the same
        if scale is not None:
            with torch.no_grad():
                for name, p in rm.named_parameters():
                    if (p.dim() >= 2 and "embed" not in name
                            and "conv" not in name):
                        p.mul_(scale)
        rcf = dataclasses.replace(rc, dtype=torch.float32, num_layers=min(
            f32_layers or rc.num_layers, rc.num_layers))
        rmf = f32_copy(rm, rcf)
        # release the init's cached f32 temporaries: a graph capture
        # allocates from a private pool, which cannot reuse the blocks they
        # leave cached (C1's capture ran out of memory beside 19 GB cached
        # and free)
        torch.cuda.empty_cache()
        n_par = sum(p.numel() for p in rm.parameters())
        rep = {"params": n_par, "layers": rc.num_layers,
               "f32_layers": rcf.num_layers}
        forbid_mono = tuple(k for k in ATTN_KERNELS if k not in mono_needs)
        forbid_paged = tuple(k for k in ATTN_KERNELS if k not in paged_needs)
        decode_needs = tuple(k for k in mono_needs
                             if k != "flash_attention_positions")
        r = np.random.default_rng(seed)
        if prompts_in is None:
            rl = [24, 200] + [int(x) for x in r.integers(24, 201, 6)]
            rp = np.zeros((8, max(rl)), np.int32)
            for i, n in enumerate(rl):
                rp[i, max(rl) - n:] = r.integers(1, rc.vocab_size, n)
        else:
            rp = prompts_in
        mn = 32

        def lg(res):
            return res["logits"].float().cpu().numpy()

        # ---- bf16: the served model
        eng = InferenceEngine(tag, rc, rm, ucfg)
        for n in (1, mn):
            eng.generate(rp, n)                 # warm up, capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = counted(f"{tag} generate", mono_needs,
                      lambda: eng.generate(rp, mn), forbid=forbid_mono)
        t_g = time.perf_counter() - t0
        ms, dms, busy_r, top_r = decode_rate(eng, rp, mn)
        rtok, ru, rlog = res["tokens"], res["u"], lg(res)
        check(rtok.shape == (8, mn) and rtok.min() >= 0
              and rtok.max() < rc.vocab_size, f"{tag}: tokens out of range")
        check(bool(np.isfinite(rlog).all()), f"{tag}: logits not finite")
        check(bool(np.isfinite(ru).all() and (ru >= 0).all()
                   and (ru <= 1).all()), f"{tag}: u outside [0, 1]: {ru}")
        print(f"[{tag}] {rc.num_layers} layers, {n_par / 1e9:.3f} B "
              f"parameters (bf16); generate B=8 S={rp.shape[1]} (bucket "
              f"{bucket_len(rp.shape[1], 1024)}) max_new={mn}: "
              f"{t_g * 1e3:.1f} ms, prefill ~{t_g * 1e3 - mn * ms:.1f} ms, "
              f"decode {ms:.3f} ms/step, device {dms:.3f} ms/step, busy "
              f"share {'not measured' if busy_r is None else f'{busy_r:.3f}'}"
              f"; {len(np.unique(rtok))} distinct tokens")
        for us, key, n in top_r:
            print(f"[{tag}]   {PROF_STEPS}-step extension: {us / 1e3:9.3f} ms in "
                  f"{n:5d} x {key[:70]}")
        rep.update(generate_s=t_g, prefill_ms=t_g * 1e3 - mn * ms,
                   decode_ms_per_step=ms, decode_device_ms_per_step=dms,
                   decode_busy_share=busy_r, u=[float(x) for x in ru],
                   profile_top=[(us / 1e3, k, n) for us, k, n in top_r])

        def serve8(e):
            return sorted(e.serve(
                [Request(rid=i, prompt=rp[i].tolist(), max_new=mn)
                 for i in range(8)], n_slots=4, decode_chunk=8),
                key=lambda x: x["rid"])
        # the graph route, bitwise the eager loop
        marks = {"served and timed": time.perf_counter() - t_ph}
        orc = eager_twin(eng)
        wspan = r.integers(1, rc.vocab_size, (8, 12)).astype(np.int32)
        session_bitwise(f"{tag} generate", eng, orc, rp, mn,
                        span=wspan if warm else None)
        fins = [serve8(e) for e in (eng, orc)]
        check(all(np.array_equal(a["tokens"], b["tokens"])
                  and a["u"] == b["u"] for a, b in zip(*fins)),
              f"{tag}: serve through graphs differs from the eager loop")
        print(f"[{tag}] serve: bitwise the eager loop")
        del orc
        marks["graph route bitwise"] = time.perf_counter() - t_ph
        # bf16 readings (reported): the batch-shape noise floor, then the
        # contract pairs
        one = [eng.generate(rp[i:i + 1], mn) for i in range(8)]
        marks["noise floor"] = time.perf_counter() - t_ph
        bf = {"B=1 vs B=8 generate (noise floor)": tie_reading(
            np.concatenate([o["tokens"] for o in one]), rtok, rlog,
            np.concatenate([lg(o) for o in one]))}
        # bf16 stepwise on the two shortest prompts (as phase 4), against
        # their rows of the B=8 generate: a reading beside the noise floor
        # (the f32 copy holds the contract on all 8)
        lens_ = (rp != 0).sum(1)
        two = np.argsort(lens_, kind="stable")[:2]
        pr2 = rp[two][:, rp.shape[1] - int(lens_[two].max()):]
        t0 = time.perf_counter()
        step = counted(f"{tag} generate_stepwise", decode_needs,
                       lambda: eng.generate_stepwise(pr2, mn),
                       forbid=forbid_mono + ("flash_attention_positions",))
        rep["stepwise_s"] = time.perf_counter() - t0
        bf["stepwise (2 prompts) vs generate"] = tie_reading(
            step["tokens"], rtok[two], rlog[two], lg(step))
        fin = counted(f"{tag} serve", mono_needs, lambda: serve8(eng),
                      forbid=forbid_mono)
        check([x["rid"] for x in fin] == list(range(8)),
              f"{tag}: serve lost a request")
        bf["serve vs generate"] = tie_reading(
            [x["tokens"] for x in fin], rtok, rlog)

        marks["bf16 stepwise, serve"] = time.perf_counter() - t_ph
        # ---- f32: the contracts, tie-aware (TIE_ATOL / TIE_ULPS)
        engf = InferenceEngine(tag + "-f32", rcf, rmf, ucfg)
        # the f32 contracts run the eager loop, which the bf16 engines hold
        # bitwise to the graph route: no capture per shape (the f32 graph
        # route is held by test_cuda_recurrent_generate_matches_cpu)
        engf._graphs = None
        gf = counted(f"{tag} f32 generate", mono_needs,
                     lambda: engf.generate(rp, mn), forbid=forbid_mono)
        ftok, fu, flog = gf["tokens"], gf["u"], lg(gf)
        f32 = {}
        sf = counted(f"{tag} f32 generate_stepwise", decode_needs,
                     lambda: engf.generate_stepwise(rp, mn),
                     forbid=forbid_mono + ("flash_attention_positions",))
        f32["stepwise vs generate"] = tie_aware(
            f"{tag} f32 stepwise vs generate", sf["tokens"], ftok, flog,
            lg(sf))
        f32["serve vs generate"] = tie_aware(
            f"{tag} f32 serve vs generate",
            [x["tokens"] for x in serve8(engf)], ftok, flog)
        rep["bf16_vs_f32"] = (tie_reading(rtok, ftok, flog, rlog)
                              if rcf.num_layers == rc.num_layers else None)

        marks["f32 contracts"] = time.perf_counter() - t_ph
        if f32_graph_layers:
            # the f32 graph route at a small depth: cold and warm
            # generate and their extension, bitwise the eager route
            rcg = dataclasses.replace(rc, dtype=torch.float32, num_layers=min(
                f32_graph_layers, rc.num_layers))
            rmg = f32_copy(rm, rcg)
            for lay, kw, needs, forbid in (
                    ("monolithic", {}, mono_needs, forbid_mono),
                    ("paged", pool, paged_needs, forbid_paged)):
                eg = InferenceEngine(f"{tag}-f32g", rcg, rmg, ucfg, **kw)
                counted(f"{tag} f32 {rcg.num_layers} layers {lay} graph "
                        "route", needs,
                        lambda: session_bitwise(
                            f"{tag} f32 {rcg.num_layers} layers {lay}", eg,
                            eager_twin(eg, **kw), rp, mn, span=wspan,
                            pools=bool(kw)), forbid=forbid)
                del eg
            del rmg
            marks["f32 graph route"] = time.perf_counter() - t_ph
        # ---- paged (R1p / R2p): bf16 serving, f32 contracts
        ptag = tag + "p"
        peng = InferenceEngine(ptag, rc, rm, ucfg, **pool)
        peng.generate(rp, mn)                   # warm up, capture
        pool_idle(f"{ptag} warm-up", peng)
        t0 = time.perf_counter()
        pres = counted(f"{ptag} paged generate", paged_needs,
                       lambda: peng.generate(rp, mn), forbid=forbid_paged)
        rep["paged_generate_s"] = time.perf_counter() - t0
        pool_idle(f"{ptag} generate", peng)
        bf["paged vs monolithic generate"] = tie_reading(
            pres["tokens"], rtok, rlog, lg(pres))
        rep["paged_bf16_max_du"] = float(np.abs(pres["u"] - ru).max())
        pengf = InferenceEngine(ptag + "-f32", rcf, rmf, ucfg, **pool)
        pengf._graphs = None
        pf = counted(f"{ptag} f32 paged generate", paged_needs,
                     lambda: pengf.generate(rp, mn), forbid=forbid_paged)
        f32["paged vs monolithic generate"] = tie_aware(
            f"{ptag} f32 paged vs monolithic generate", pf["tokens"], ftok,
            flog, lg(pf))
        same = (pf["tokens"] == ftok).all(axis=1)
        du = float(np.abs(pf["u"] - fu)[same].max()) if same.any() else 0.0
        check(du <= 1e-2, f"{ptag}: f32 paged u {du} from the monolithic")
        rep["paged_f32_max_du"] = du
        sysp = r.integers(1, rc.vocab_size, (1, 200)).astype(np.int32)
        spans = r.integers(1, rc.vocab_size, (16, 12)).astype(np.int32)
        c0 = dict(pengf.counters)
        rc0 = pengf.pool.counters["row_copies"]

        def fan():
            st = pengf.absorb(sysp)
            out = pengf.generate(spans, 16, state=pengf.fanout(st, 16),
                                 return_state=True)
            return st, out
        t0 = time.perf_counter()
        st, fres = counted(f"{ptag} f32 absorb + fanout 16 + continue",
                           paged_needs, fan, forbid=forbid_paged)
        rep["fanout_s"] = time.perf_counter() - t0
        check(pengf.counters["prefill"] - c0["prefill"] == 1
              and pengf.counters["prefill_continue"]
              - c0["prefill_continue"] == 1,
              f"{ptag}: fan-out ran other than one cold prefill and one "
              "continuation")
        check(pengf.pool.counters["row_copies"] - rc0 == 16,
              f"{ptag}: fan-out copied "
              f"{pengf.pool.counters['row_copies'] - rc0} rows, want 16")
        cold = engf.generate(np.concatenate([np.tile(sysp, (16, 1)), spans],
                                            axis=1), 16)
        f32["fanout vs cold concatenation"] = tie_aware(
            f"{ptag} f32 fanned continuation vs cold concatenation",
            fres["tokens"], cold["tokens"], lg(cold), lg(fres))
        pengf.release(fres["state"])
        ext = pengf.generate(None, 12, state=pengf.fanout(st, 1),
                             return_state=True)
        pengf.release(ext["state"])
        c1 = dict(pengf.counters)
        sfin = counted(
            f"{ptag} f32 serve, 16 requests on one handle",
            tuple(k for k in paged_needs
                  if k != "flash_attention_positions"),
            lambda: pengf.serve([Request(rid=k, prompt=[], max_new=12,
                                         state=st) for k in range(16)],
                                n_slots=8, decode_chunk=4),
            forbid=forbid_paged + ("flash_attention_positions",))
        check(len(sfin) == 16 and pengf.counters["prefill"] == c1["prefill"]
              and pengf.counters["prefill_continue"]
              == c1["prefill_continue"],
              f"{ptag}: serve on a handle lost a request or prefilled")
        f32["serve on a handle vs its extension"] = tie_aware(
            f"{ptag} f32 serve on one handle vs the session's extension",
            [x["tokens"] for x in sorted(sfin, key=lambda x: x["rid"])],
            np.repeat(ext["tokens"], 16, axis=0),
            np.repeat(lg(ext), 16, axis=0))
        pengf.release(st)
        pool_idle(f"{ptag} f32 fan-out and serve", pengf)
        # two fresh bf16 pools: a freed block or row keeps its bytes until
        # it is handed out again, so only pools with the same history
        # compare
        pg = InferenceEngine(ptag + "-graph", rc, rm, ucfg, **pool)
        tw = eager_twin(pg, **pool)
        session_bitwise(f"{ptag} paged generate", pg, tw, rp, mn,
                        pools=True)
        pool_idle(f"{ptag} graph route", pg)
        del pg, tw
        for k, v in f32.items():
            print(f"[{tag}] f32 {k}: tie-aware equal ({v[0]} rows diverged "
                  f"at a tie, logits {v[2]:.2e} apart, reading {v[1]:.4f})")
        for k, v in bf.items():
            print(f"[{tag}] bf16 {k}: reading {v[1]:.3f} ({v[2]:.4f} apart "
                  f"before a flip, {v[0]} rows diverged) - reported")
        vs = rep["bf16_vs_f32"]
        print(f"[{tag}] " + (f"bf16 generate vs f32 generate: reading "
                             f"{vs[1]:.3f} ({vs[2]:.4f} apart); " if vs
                             else f"f32 copy of {rcf.num_layers} layers; ")
              + f"paged u within {du:.2e} (f32), "
              f"{rep['paged_bf16_max_du']:.2e} (bf16); fan-out copied 16 "
              "rows; every pool back at 0 blocks and 0 rows")
        rep["f32_tie"] = {k: list(v) for k, v in f32.items()}
        rep["bf16_tie"] = {k: list(v) for k, v in bf.items()}
        rep["phase_s"] = time.perf_counter() - t_ph
        marks["paged"] = rep["phase_s"]
        rep["seconds_at"] = marks
        print(f"[{tag}] seconds into the phase at the end of each part: "
              + ", ".join(f"{k} {v:.1f}" for k, v in marks.items()))
        return rc, rm, rcf, rmf, eng, peng, engf, pengf, rep, rp

    (rgc, rgm, rgcf, rgmf, rg, prg, rgf, prgf, rg_rep,
     rg_prompts) = model_phase("R1", "recurrentgemma-2b", SEED + 50,
                               SERVE_KERNELS, PAGED_SERVE, layers=5,
                               f32_graph_layers=3)
    d3_mesh11("recurrentgemma-2b", rg, {}, SERVE_KERNELS,
              ("paged_decode_attention", "flash_attention"))
    d3_mesh11("recurrentgemma-2b paged", prg, RPOOL, PAGED_SERVE,
              ("decode_attention", "flash_attention"))
    # the ring wraps: two ~2300-token prompts over the 2048-slot window,
    # bf16 (served, timed) and f32 (monolithic vs ring tables, tie-aware)
    wrng = np.random.default_rng(SEED + 51)
    wp = wrng.integers(1, rgc.vocab_size, (2, 2300)).astype(np.int32)
    t0 = time.perf_counter()
    wres = counted("R1 ring wrap generate", SERVE_KERNELS,
                   lambda: rg.generate(wp, 16, return_state=True),
                   forbid=("paged_decode_attention", "flash_attention"))
    t_wrap = time.perf_counter() - t0
    local = [c for c, (m, _) in zip(wres["state"].cache,
                                    rgc.layer_plan()) if m == "attn_local"]
    check(all(c.k.shape[1] == rgc.window for c in local)
          and all(int(c.pos.max()) >= rgc.window + 250 for c in local),
          "R1 wrap: the local layers' rings did not wrap")
    check(bool(torch.isfinite(wres["logits"]).all()),
          "R1 wrap: logits not finite")
    del local, wres["state"]
    pw = counted("R1p ring wrap generate (ring tables)", PAGED_SERVE,
                 lambda: prg.generate(wp, 16),
                 forbid=("decode_attention", "flash_attention"))
    pool_idle("R1p ring wrap", prg)
    wrap_bf = tie_reading(pw["tokens"], wres["tokens"],
                          wres["logits"].float().cpu().numpy(),
                          pw["logits"].float().cpu().numpy())
    wf = counted("R1 f32 ring wrap generate", SERVE_KERNELS,
                 lambda: rgf.generate(wp, 16),
                 forbid=("paged_decode_attention", "flash_attention"))
    pwf = counted("R1p f32 ring wrap generate (ring tables)", PAGED_SERVE,
                  lambda: prgf.generate(wp, 16),
                  forbid=("decode_attention", "flash_attention"))
    pool_idle("R1p f32 ring wrap", prgf)
    wrap_tie = tie_aware("R1p f32 ring wrap paged vs monolithic",
                         pwf["tokens"], wf["tokens"],
                         wf["logits"].float().cpu().numpy(),
                         pwf["logits"].float().cpu().numpy())
    print(f"[R1] ring wrap: B=2 S=2300 (bucket {bucket_len(2300, 1024)}) + "
          f"16 tokens in {t_wrap:.2f} s (bf16); positions up to "
          f"{2300 + 15} on {rgc.window}-slot rings; ring tables vs "
          f"monolithic: f32 tie-aware equal (reading {wrap_tie[1]:.4f}), "
          f"bf16 reading {wrap_bf[1]:.3f} (reported)")
    rg_rep["wrap"] = {"generate_s": t_wrap, "f32_tie": list(wrap_tie),
                      "bf16_tie": list(wrap_bf)}
    # a wrong path the f32 budget must reject: no decode step writes its
    # K/V into the ring (phase 6's wrong path)
    rg_rep["f32_wrong_path"] = wrong_path(
        "R1", rgf, rg_prompts, "no decode step writes its K/V",
        lambda: swapped(attention, "_write_slot", lambda *a, **k: None))
    q8 = InferenceEngine("R1p-int8", rgc, rgm, ucfg, cache_quant="int8",
                         **RPOOL)
    qres = counted("R1p int8 pool generate", PAGED_SERVE,
                   lambda: q8.generate(rg_prompts, 32),
                   forbid=("decode_attention", "flash_attention"))
    pool_idle("R1p int8 pool", q8)
    ql = qres["logits"].float().cpu().numpy()
    check(bool(np.isfinite(ql).all()), "R1p int8 pool: logits not finite")
    ref8 = rg.generate(rg_prompts, 32)
    qflips, _, qd = tie_reading(qres["tokens"], ref8["tokens"],
                                ref8["logits"].float().cpu().numpy(), ql)
    qagree = float((qres["tokens"] == ref8["tokens"]).mean())
    print(f"[R1p] int8 pool vs the bf16 monolithic engine: logits {qd:.4f} "
          f"apart before a divergence, {qflips} rows diverged, token "
          f"agreement {qagree:.3f}")
    rg_rep["int8_pool"] = {"max_dlogit_before_divergence": qd,
                           "rows_diverged": qflips,
                           "token_agreement": qagree}
    print(f"[R1] phase {rg_rep['phase_s']:.1f} s (R1p included)")
    recurrent_rep["recurrentgemma-2b"] = rg_rep
    del rg, prg, rgf, prgf, q8, rgm, rgmf, qres, pw, pwf, wf, wres
    gc.collect()
    torch.cuda.empty_cache()

    (mc, mm, mcf, mmf, mb, pmb, mbf, pmbf, mb_rep, mb_prompts) = \
        model_phase("R2", "mamba2-780m", SEED + 60,
                    ("swarm_uncertainty",), ("swarm_uncertainty",),
                    layers=4, f32_graph_layers=2)
    d3_mesh11("mamba2-780m", mb, {}, ("swarm_uncertainty",), ATTN_KERNELS)
    check(pmb.pool.row_bytes > 0 and pmb.pool.block_bytes == 0,
          "R2: the SSD pool holds KV blocks or no state rows")
    mb_rep["row_mb"] = pmb.pool.row_bytes / 1e6
    # a wrong path the f32 budget must reject: decode drops the SSD state
    from repro_torch.models import ssm as ssm_mod
    orig_dec = ssm_mod.ssd_decode

    def dropped(p, x, state, c):
        out, s = orig_dec(p, x, state, c)
        s.ssd.zero_()
        return out, s
    mb_rep["f32_wrong_path"] = wrong_path(
        "R2", mbf, mb_prompts, "decode drops the SSD state",
        lambda: swapped(ssm_mod, "ssd_decode", dropped))
    del mbf, pmbf, mmf
    # a swarm round (the reference's TestSwarmStateReuse): a smollm-135m
    # probe whose answer is precomputed beside a mamba2-780m peer, on the
    # study workload's prompts
    scfg = configs.get_config("smollm-135m")
    sprobe = InferenceEngine("R2-probe", scfg, init_params(
        scfg, torch.Generator(device=dev).manual_seed(SEED + 61),
        device=dev), ucfg)
    sq = pad_prompts([q["prompt"] for q in world.study_workload()])
    sres = sprobe.generate(sq, 8, return_state=True)
    pre = {0: (sres["tokens"], sres["u"], (sres["h_mean"], sres["v_mean"]))}
    before = dict(sprobe.counters)
    pf0 = mb.counters["prefill"]

    def round_():
        return SwarmExecutor([sprobe, mb]).collaborate(
            sq, 8, precomputed=pre, states={0: sres["state"]})
    round_()                                    # capture the peer's graphs
    t0 = time.perf_counter()
    sw = counted("R2 swarm round: smollm probe + mamba2 peer",
                 ("swarm_uncertainty",), round_, forbid=ATTN_KERNELS)
    t_sw = time.perf_counter() - t0
    check(sprobe.counters == before, "R2 swarm: the precomputed probe ran "
                                     "a dispatch")
    check(mb.counters["prefill"] > pf0, "R2 swarm: the peer did not run")
    check(np.array_equal(sw["answers"][:, 0], sres["tokens"]),
          "R2 swarm: the probe's answers changed")
    check(bool(np.isfinite(sw["u"]).all()), "R2 swarm: u not finite")
    print(f"[R2] swarm round, {sq.shape[0]} study prompts, smollm-135m probe "
          f"(precomputed, no dispatch) + mamba2-780m peer: {t_sw:.3f} s")
    mb_rep["swarm_round_s"] = t_sw
    print(f"[R2] phase {mb_rep['phase_s']:.1f} s, state row "
          f"{mb_rep['row_mb']:.1f} MB")
    recurrent_rep["mamba2-780m"] = mb_rep
    report["recurrent"] = recurrent_rep
    del mb, pmb, mm, sprobe, sres, sw
    gc.collect()
    torch.cuda.empty_cache()

    # ---- M0-M3. the MoE family at published widths ----------------------
    # deepseek-moe-16b (28 layers: one dense, then 27 of 64 experts top-6
    # + 2 shared; 16 query heads on 16 KV heads, head_dim 128, vocabulary
    # 102400) and llama4-scout-17b-a16e (48 layers of 16 experts top-1 + 1
    # shared; 40 query heads on 8 KV heads, vocabulary 202048).  MoE has
    # no kernel of its own (the reference's experts are XLA einsums): the
    # experts run as torch.bmm over the capacity buffer, rows 1-5 at these
    # shapes
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import moe as moe_mod
    t_m = time.perf_counter()
    moe_rep: dict = {}
    MOE_ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
    mcfgs = {a: configs.get_config(a) for a in MOE_ARCHS}
    short = dict(zip(MOE_ARCHS, ("deepseek", "llama4")))
    # a paged pool for M1's 8 x 320-slot sessions and M2's fan-out (128
    # blocks of 64: 1.9 GB of deepseek's bf16 K/V)
    MPOOL = dict(paged=True, block_len=64, pool_blocks=128, pool_rows=40)

    # M0: rows 1, 2, 3 and 5 at the MoE shapes: B=8, the S=256 bucket of
    # phase 4's prompts (56 padding columns), decode at positions 256-287
    # of the 320-slot cache, the paged pool's 5 blocks of 64 per row under
    # 32 delta rows (a 32-step dispatch)
    m0_cases = []
    for a, mc in mcfgs.items():
        H, K, D = mc.num_heads, mc.num_kv_heads, mc.head_dim
        G, n = H // K, short[a]
        m0_cases += [
            flash_case(f"M0 {n} prefill B8 S256 H{H} K{K} D{D}", 8, 256, H,
                       K, D, 56),
            decode_case(f"M0 {n} decode B8 T320 positions 256-287 G{G} "
                        f"D{D}", 8, 320, K, G, D, fill=(56, 256, 288)),
            uncertainty_case(f"M0 {n} B8 V{mc.vocab_size}", 8,
                             mc.vocab_size),
            paged_case(f"M0 paged {n} B8 L64 nb5 S32 G{G} D{D}", 8, K, G, D,
                       nb=5, p0=256, S=32)]
    hold_cases("M0", m0_cases)
    moe_rep["kernel_cases"] = m0_cases

    # row 4 through ``forward`` at deepseek's width (the dense layer and
    # one MoE layer), against the same forward with the plain op swapped
    # in: in f32 (a bf16 ulp of attention output can flip a near-tie in
    # the router, a different expert, not noise), then bf16 reported
    fwd = {}
    for dt in (torch.float32, torch.bfloat16):
        dc2 = dataclasses.replace(mcfgs["deepseek-moe-16b"], num_layers=2,
                                  dtype=dt)
        dm2 = init_params(dc2, torch.Generator(device=dev).manual_seed(
            SEED + 70), device=dev)
        ftok = torch.randint(1, dc2.vocab_size, (8, 256), generator=gen,
                             device=dev, dtype=torch.int32)
        r = fwd[str(dt)[6:]] = forward_held(
            "M0", dm2, dc2, {"tokens": ftok},
            f"deepseek forward {str(dt)[6:]} (2 layers) B=8 S=256",
            hold=dt == torch.float32)
        check(r["aux"] > 0, f"M0 deepseek forward: aux {r['aux']}")
        del dm2
    moe_rep["forward_row4"] = fwd
    torch.cuda.empty_cache()

    # one full-width MoE layer of each config: on the card against the
    # port's CPU path in f32 on the same weights (prefill S=16 and decode,
    # both decode impls), then in bf16 per-layer times at M1's shapes
    layer_rep = {}
    for a, mc in mcfgs.items():
        n = short[a]
        D, E, k, Fe = mc.d_model, mc.num_experts, mc.top_k, mc.expert_d_ff
        Fs = mc.num_shared_experts * Fe
        cf = dataclasses.replace(mc, dtype=torch.float32)
        lay = transformer.init_weights(
            moe_mod.MoE(cf, device=dev), cf,
            torch.Generator(device=dev).manual_seed(SEED + 71))
        lay_c = moe_mod.MoE(cf)                      # the CPU copy
        with torch.no_grad():
            for a_, b_ in zip(lay_c.parameters(), lay.parameters()):
                a_.copy_(b_)
        x = torch.randn(8, 16, D, generator=torch.Generator().manual_seed(
            SEED + 72))
        ps = torch.arange(16, dtype=torch.int32).expand(8, 16)
        errs = {}
        with torch.inference_mode():
            yc = moe_mod.moe_prefill_block(lay_c, x, cf, ps)[0] - x
            yd = moe_mod.moe_prefill_block(lay, x.to(dev), cf,
                                           ps.to(dev))[0].cpu() - x
            errs["prefill S16"] = float((yd - yc).abs().max()
                                        / yc.abs().max())
            for impl in ("dispatch", "gather"):
                ci = dataclasses.replace(cf, moe_decode_impl=impl)
                yc = moe_mod.moe_decode_block(lay_c, x[:, :1], ci)[0] - x[:, :1]
                yd = moe_mod.moe_decode_block(
                    lay, x[:, :1].to(dev), ci)[0].cpu() - x[:, :1]
                errs[f"decode {impl}"] = float((yd - yc).abs().max()
                                               / yc.abs().max())
        for kind, e in errs.items():
            check(e <= 1e-4, f"M0 {n} MoE layer {kind}: the card is {e:.2e} "
                             "(relative) from the CPU path")
        del lay_c
        # bf16 per-layer times: the prefill dispatch at B=8 S=256 (56
        # padding columns), the decode step at B=8, dispatch and gather
        lay = lay.to(torch.bfloat16)
        cb = mc
        xb = randn(8, 256, D)
        pb = (torch.arange(256, dtype=torch.int32, device=dev) - 56).expand(
            8, 256)
        # a layer is ~40-60 kernels: a ~25 ms spin covers their enqueue
        with torch.inference_mode():
            ms_pre = time_ms(lambda: moe_mod.moe_prefill_block(lay, xb, cb,
                                                               pb),
                             spin=40_000_000)
            x1 = randn(8, 1, D)
            ms_dec = {}
            for impl in ("dispatch", "gather"):
                ci = dataclasses.replace(cb, moe_decode_impl=impl)
                ms_dec[impl] = time_ms(lambda: moe_mod.moe_decode_block(
                    lay, x1, ci), spin=40_000_000)
        per_row = 2 * 3 * D * Fe                     # one row through one expert
        shared_f = 8 * 256 * 2 * 3 * D * Fs
        f_disp = 256 * E * 8 * per_row + shared_f    # S groups x E x C=B
        f_real = 200 * 8 * k * per_row + shared_f    # the valid tokens' k rows
        wbytes = 2 * 3 * D * Fe
        b_disp = E * wbytes + 2 * 3 * D * Fs         # every expert + shared
        b_gath = 8 * k * wbytes + 2 * 3 * D * Fs     # the B*k gathered rows
        lr = {"prefill_ms": ms_pre,
              "prefill_tflops_dispatch_rows": f_disp / ms_pre / 1e9,
              "prefill_tflops_real_rows": f_real / ms_pre / 1e9,
              "prefill_bound_ms_dispatch": f_disp / BF16_FLOPS * 1e3,
              "decode_ms": ms_dec,
              "decode_bound_ms": {"dispatch": b_disp / HBM_BPS * 1e3,
                                  "gather": b_gath / HBM_BPS * 1e3},
              "expert_bytes_read": {"dispatch": b_disp, "gather": b_gath},
              "f32_rel_err_vs_cpu": errs}
        layer_rep[a] = lr
        print(f"[M0] {n} MoE layer (E={E}, k={k}, Fe={Fe}, shared {Fs}): "
              f"card vs CPU f32 relative " + ", ".join(
                  f"{kk} {v:.1e}" for kk, v in errs.items()) + "; bf16 "
              f"prefill B8 S256 {ms_pre:.3f} ms ({lr['prefill_tflops_dispatch_rows']:.1f}"
              f" TFLOP/s over the dispatch's E*C rows, "
              f"{lr['prefill_tflops_real_rows']:.2f} over the B*k real "
              f"rows; bound {lr['prefill_bound_ms_dispatch']:.3f} ms); decode "
              f"B8 dispatch {ms_dec['dispatch']:.3f} ms ({b_disp / 1e9:.3f} "
              f"GB of experts, bound {b_disp / HBM_BPS * 1e3:.3f} ms), "
              f"gather {ms_dec['gather']:.3f} ms ({b_gath / 1e9:.3f} GB, "
              f"bound {b_gath / HBM_BPS * 1e3:.3f} ms)")
        del lay, xb, x1
    moe_rep["layer"] = layer_rep
    torch.cuda.empty_cache()
    print(f"[M0] phase {time.perf_counter() - t_m:.1f} s")

    def lowest_k(router, h, c, valid=None, tp=None):
        """The router taking the k LEAST likely experts."""
        logits = h.float() @ router.float()
        if valid is not None:
            logits = torch.where(valid[..., None], logits, moe_mod._MASKED)
        probs = torch.softmax(logits, dim=-1)
        g, i = torch.topk(probs, c.top_k, dim=-1, largest=False)
        return g / g.sum(-1, keepdim=True).clamp_min(1e-9), i, probs

    def padding_neutral(tag, e, pr, mn=32):
        """``generate`` (its bucket) against the same prefill over 256 more
        inert columns and the same decode: tie-aware."""
        B, S = pr.shape
        ref = e.generate(pr, mn)
        wide = np.zeros((B, e._bucket(pr)[0].shape[1] + 256), np.int32)
        wide[:, -S:] = pr
        cur, last, cache = e._prefill_absorb(
            wide, S, e._cache_len(wide.shape[1], mn))
        toks, lgs, *_ = e._dispatch("mono", cur, last, cache, e._full(B, S),
                                    mn, True, None)
        return list(tie_aware(f"{tag} f32 bucket padding ({wide.shape[1]} "
                              f"columns vs {e._bucket(pr)[0].shape[1]})",
                              toks.cpu().numpy(), ref["tokens"],
                              ref["logits"].float().cpu().numpy(),
                              lgs.float().cpu().numpy()))

    # ---- M1. deepseek-moe-16b at published widths, 3 of 28 layers -------
    held_m = torch.cuda.memory_allocated() / 1e9
    print(f"[M1] {held_m:.2f} GB held on the card before M1")
    (dsc, dsm, dscf, dsmf, ds, pds, dsf, pdsf, ds_rep, ds_prompts) = \
        model_phase("M1", "deepseek-moe-16b", SEED + 80, SERVE_KERNELS,
                    PAGED_SERVE, layers=3, f32_layers=3, scale=None,
                    prompts_in=prompts, pool=MPOOL, warm=True)
    d3_mesh11("deepseek-moe-16b", ds, {}, SERVE_KERNELS,
              ("paged_decode_attention", "flash_attention"))
    ds_rep["held_gb_before"] = held_m
    ds_rep["f32_padding"] = padding_neutral("M1", dsf, ds_prompts)
    ds_rep["f32_wrong_lowest_k"] = wrong_path(
        "M1", dsf, ds_prompts, "the router takes the k lowest experts",
        lambda: swapped(moe_mod, "_route_topk", lowest_k))
    print(f"[M1] phase {ds_rep['phase_s']:.1f} s (M1p included), "
          f"{ds_rep['params'] / 1e9:.3f} B parameters")
    moe_rep["deepseek-moe-16b"] = ds_rep
    del dsm, dsmf, ds, pds, dsf, pdsf
    gc.collect()
    torch.cuda.empty_cache()

    # ---- M2. llama4-scout-17b-a16e at published widths, 2 layers ---------
    (lsc, lsm, lscf, lsmf, ls, pls, lsf, plsf, ls_rep, ls_prompts) = \
        model_phase("M2", "llama4-scout-17b-a16e", SEED + 90, SERVE_KERNELS,
                    PAGED_SERVE, layers=2, f32_layers=2, scale=None,
                    prompts_in=prompts, pool=MPOOL)
    d3_mesh11("llama4-scout-17b-a16e", ls, {}, SERVE_KERNELS,
              ("paged_decode_attention", "flash_attention"))
    torch.distributed.destroy_process_group()
    del d3_rep["mesh"]
    report.setdefault("mesh_d3", {})["mesh11"] = d3_rep["mesh11"]
    print("[D3] (1, 1) mesh: recurrentgemma-2b (monolithic and paged), "
          "mamba2-780m, deepseek-moe-16b, llama4-scout-17b-a16e: each "
          "generate bitwise the single-device engine's, one graph launch")
    ls_rep["f32_padding"] = padding_neutral("M2", lsf, ls_prompts)
    ls_rep["f32_wrong_no_shared"] = wrong_path(
        "M2", lsf, ls_prompts, "the combine drops the shared expert",
        lambda: swapped(ffn_mod, "mlp_body",
                        lambda p, h, c: torch.zeros_like(h)))
    # the gather decode: f32 tie-aware equal to the dispatch, bf16 read
    # beside it and timed
    ge = {}
    torch.cuda.empty_cache()
    for dt_tag, c_, m_, ref_e in (("f32", lscf, lsmf, lsf),
                                  ("bf16", lsc, lsm, ls)):
        e = InferenceEngine(f"M2-gather-{dt_tag}", dataclasses.replace(
            c_, moe_decode_impl="gather"), m_, ucfg)
        if dt_tag == "f32":
            # the f32 contracts run the eager route, as model_phase's do (a
            # capture's private pool beside the f32 copy ran out of memory)
            e._graphs = None
        gres = counted(f"M2 {dt_tag} generate (gather decode)", SERVE_KERNELS,
                       lambda: e.generate(ls_prompts, 32),
                       forbid=("paged_decode_attention", "flash_attention"))
        dres = ref_e.generate(ls_prompts, 32)
        args = (gres["tokens"], dres["tokens"],
                dres["logits"].float().cpu().numpy(),
                gres["logits"].float().cpu().numpy())
        ge[dt_tag] = list(tie_aware("M2 f32 gather vs dispatch decode", *args)
                          if dt_tag == "f32" else tie_reading(*args))
        if dt_tag == "bf16":
            ge["bf16_decode_ms_per_step"] = decode_rate(e, ls_prompts, 32)[0]
        del e
    del c_, m_, ref_e, gres, dres         # the loop's last model and engine
    print(f"[M2] gather decode vs dispatch: f32 tie-aware equal (reading "
          f"{ge['f32'][1]:.4f}), bf16 reading {ge['bf16'][1]:.3f} "
          f"(reported); bf16 decode {ge['bf16_decode_ms_per_step']:.3f} "
          f"ms/step (dispatch {ls_rep['decode_ms_per_step']:.3f})")
    ls_rep["gather"] = ge
    # a swarm round on the study workload's prompts: a smollm-135m probe
    # whose answer is precomputed beside the llama4 peer
    mprobe = InferenceEngine("M2-probe", scfg, init_params(
        scfg, torch.Generator(device=dev).manual_seed(SEED + 91),
        device=dev), ucfg)
    mres = mprobe.generate(sq, 8, return_state=True)
    mpre = {0: (mres["tokens"], mres["u"], (mres["h_mean"],
                                            mres["v_mean"]))}
    mbefore = dict(mprobe.counters)
    lpf0 = ls.counters["prefill"]

    def mround():
        return SwarmExecutor([mprobe, ls]).collaborate(
            sq, 8, precomputed=mpre, states={0: mres["state"]})
    mround()                                    # capture the peer's graphs
    t0 = time.perf_counter()
    msw = counted("M2 swarm round: smollm probe + llama4 peer",
                  SERVE_KERNELS, mround,
                  forbid=("paged_decode_attention", "flash_attention"))
    t_msw = time.perf_counter() - t0
    check(mprobe.counters == mbefore, "M2 swarm: the precomputed probe ran "
                                      "a dispatch")
    check(ls.counters["prefill"] > lpf0, "M2 swarm: the MoE peer did not run")
    check(np.array_equal(msw["answers"][:, 0], mres["tokens"]),
          "M2 swarm: the probe's answers changed")
    check(bool(np.isfinite(msw["u"]).all()), "M2 swarm: u not finite")
    print(f"[M2] swarm round, {sq.shape[0]} study prompts, smollm-135m probe "
          f"(precomputed, no dispatch) + llama4-scout peer (2 layers): "
          f"{t_msw:.3f} s")
    ls_rep["swarm_round_s"] = t_msw
    print(f"[M2] phase {ls_rep['phase_s']:.1f} s (M2p included), "
          f"{ls_rep['params'] / 1e9:.3f} B parameters")
    moe_rep["llama4-scout-17b-a16e"] = ls_rep
    del lsm, lsmf, ls, pls, lsf, plsf, mprobe, mres, msw
    gc.collect()
    torch.cuda.empty_cache()

    # ---- M3. training deepseek-moe-16b at published widths, 2 layers -----
    # the dense layer and one MoE layer, batch 4, seq 128, 6 AdamW steps
    # (lr 3e-4, warm-up 1): the loss falls, moe_aux finite and positive,
    # every parameter moves, no kernel launched
    t_phase = time.perf_counter()
    mtc = dataclasses.replace(mcfgs["deepseek-moe-16b"], num_layers=2)
    mtm = init_params(mtc, torch.Generator(device=dev).manual_seed(SEED + 95),
                      device=dev)
    mbefore = [p.detach().to("cpu", copy=True) for p in mtm.parameters()]
    mst = opt.init(mtm)
    mstep = TR.build_train_step(mtc, opt.AdamWConfig(
        lr=3e-4, total_steps=6, warmup_steps=1), moe_groups=1)
    mpipe = SyntheticLMPipeline(4, 128, seed=SEED)
    mb_ = [device_put_batch(mpipe.get_batch(i), dev) for i in range(6)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m_s, m_loss, m_aux = [], [], []

    def mtrain():
        for b in mb_:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, m = mstep(mtm, mst, b)
            torch.cuda.synchronize()
            m_s.append(time.perf_counter() - t)
            m_loss.append(float(m["loss"]))
            m_aux.append(float(m["moe_aux"]))
    counted("M3 train deepseek-moe-16b (2 layers)", (), mtrain,
            forbid=KERNELS)
    check(bool(np.isfinite(m_loss).all())
          and np.mean(m_loss[-3:]) < np.mean(m_loss[:3]),
          f"M3: the loss did not fall: {m_loss}")
    check(all(np.isfinite(a) and a > 0 for a in m_aux),
          f"M3: moe_aux not finite and positive: {m_aux}")
    unmoved = [n for (n, p), b in zip(mtm.named_parameters(), mbefore)
               if torch.equal(p.detach().cpu(), b)]
    check(not unmoved, f"M3: parameters unchanged: {unmoved[:5]}")
    m_ms = float(np.median(m_s[2:])) * 1e3
    m_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[M3] train deepseek-moe-16b (2 layers: dense + MoE) B=4 S=128: "
          f"loss {m_loss[0]:.4f} -> {m_loss[-1]:.4f}, moe_aux "
          f"{m_aux[0]:.4f} -> {m_aux[-1]:.4f}, {m_ms:.2f} ms/step (median of "
          f"steps 3-6), peak {m_peak:.2f} GB; every parameter moved, no "
          "kernel launched")
    moe_rep["train"] = {"losses": m_loss, "moe_aux": m_aux,
                        "ms_per_step": m_ms, "peak_gb": m_peak,
                        "phase_s": time.perf_counter() - t_phase}
    del mtm, mst, mstep, mb_, mbefore
    gc.collect()
    torch.cuda.empty_cache()
    moe_rep["phase_s"] = time.perf_counter() - t_m
    print(f"[M] M0-M3 {moe_rep['phase_s']:.1f} s")
    report["moe"] = moe_rep

    # ---- X0 / C1 / V1 / H1 / S1. the last three architectures and -------
    # session checkpoints: command-r-plus-104b (dense GQA, 96 query heads
    # on 8 KV heads so G=12, head_dim 128, vocabulary 256000),
    # llava-next-mistral-7b (576 vision-patch embeddings ahead of the text,
    # 32 query heads on 8, vocabulary 32000), hubert-xlarge (an encoder of
    # 48 bidirectional gelu layers over audio-frame embeddings, 16 heads of
    # 80); then checkpoint and restore of the probe's sessions.  No new
    # kernel: rows 1-5 at these shapes
    t_new = time.perf_counter()
    new_rep: dict = {}
    held_n = torch.cuda.memory_allocated() / 1e9
    print(f"[X0] {held_n:.2f} GB held on the card before X0")
    new_rep["held_gb_before"] = held_n
    crc = configs.get_config("command-r-plus-104b")
    vlc = configs.get_config("llava-next-mistral-7b")
    hbc = configs.get_config("hubert-xlarge")

    # X0: rows 1, 2, 3 and 5 at command-r's shapes (B=8, an S=256 prefill
    # with 56 padding columns, decode at positions 256-287 of 320 slots, a
    # paged table of 5 blocks under 32 delta rows, V=256000); row 4 at
    # llava's forward (576 patches + 448 text, causal) and at hubert's
    # (S=1000, so the last tile is ragged; D=80 padded to 128), bf16 and f32
    H, K, D = crc.num_heads, crc.num_kv_heads, crc.head_dim
    G = H // K
    x0_cases = [
        flash_case(f"X0 command-r prefill B8 S256 H{H} K{K} D{D}", 8, 256, H,
                   K, D, 56),
        decode_case(f"X0 command-r decode B8 T320 positions 256-287 G{G} "
                    f"D{D}", 8, 320, K, G, D, fill=(56, 256, 288)),
        uncertainty_case(f"X0 command-r B8 V{crc.vocab_size}", 8,
                         crc.vocab_size),
        paged_case(f"X0 paged command-r B8 L64 nb5 S32 G{G} D{D}", 8, K, G,
                   D, nb=5, p0=256, S=32),
        grid_case(f"X0 llava forward B4 S1024 H{vlc.num_heads} "
                  f"K{vlc.num_kv_heads} D{vlc.head_dim} causal", 4, 1024,
                  vlc.num_heads, vlc.num_kv_heads, vlc.head_dim, causal=True),
        *(grid_case(f"X0 hubert forward B4 S1000 H{hbc.num_heads} "
                    f"K{hbc.num_kv_heads} D{hbc.head_dim} bidirectional "
                    f"{str(dt)[6:]}", 4, 1000, hbc.num_heads,
                    hbc.num_kv_heads, hbc.head_dim, causal=False, dtype=dt)
          for dt in (torch.bfloat16, torch.float32))]
    hold_cases("X0", x0_cases)
    new_rep["kernel_cases"] = x0_cases

    def decode_bound_ms(m, B=8):
        """A decode step's least time: every weight but the embedding table
        read once (the step reads B of its rows) over the HBM rate."""
        nb = sum(p.numel() * p.element_size()
                 for n, p in m.named_parameters() if n != "embed")
        nb += B * m.embed.shape[1] * m.embed.element_size()
        return nb / HBM_BPS * 1e3, nb

    # ---- C1. command-r-plus-104b at published widths, 2 of 64 layers -----
    # (~19 GB of bf16 weights: the embedding and the untied head are 12.6
    # GB, each layer 3.1 GB); phase 4's prompts, monolithic and on a
    # 128-block pool; the contracts on an f32 copy of 1 layer (31 GB: the
    # f32 embedding and head alone are 25 GB)
    (c1c, c1m, c1cf, c1mf, c1, pc1, c1f, pc1f, c1_rep, c1_prompts) = \
        model_phase("C1", "command-r-plus-104b", SEED + 110, SERVE_KERNELS,
                    PAGED_SERVE, layers=2, f32_layers=1, scale=None,
                    prompts_in=prompts, pool=MPOOL)
    c1_rep["f32_wrong_no_kv_write"] = wrong_path(
        "C1", c1f, c1_prompts, "decode never writes its K/V",
        lambda: drop_cache_write(c1cf.num_layers, None,
                                 range(c1cf.num_layers)))
    b_ms, b_bytes = decode_bound_ms(c1m)
    c1_rep.update(decode_bound_ms=b_ms, decode_bytes=b_bytes)
    print(f"[C1] decode {c1_rep['decode_ms_per_step']:.3f} ms/step (busy "
          f"{c1_rep['decode_busy_share']}) against a byte bound of "
          f"{b_ms:.3f} ms ({b_bytes / 1e9:.2f} GB a step); prefill "
          f"{c1_rep['prefill_ms']:.1f} ms; phase {c1_rep['phase_s']:.1f} s")
    new_rep["command-r-plus-104b"] = c1_rep
    del c1m, c1mf, c1, pc1, c1f, pc1f
    gc.collect()
    torch.cuda.empty_cache()

    # ---- V1. llava-next-mistral-7b at published widths, 16 of 32 layers --
    # the token backbone served through C1's paths (the engine reads
    # tokens, as the reference's does; prompts in its 32000 vocabulary),
    # contracts on an f32 copy of 4 layers; then ``forward`` on 576 patch
    # embeddings + 448 text tokens through row 4
    t_v = time.perf_counter()
    (v1c, v1m, v1cf, v1mf, v1, pv1, v1f, pv1f, v1_rep, v1_prompts) = \
        model_phase("V1", "llava-next-mistral-7b", SEED + 120, SERVE_KERNELS,
                    PAGED_SERVE, layers=16, f32_layers=4, scale=None,
                    pool=MPOOL)
    v1_rep["f32_wrong_no_kv_write"] = wrong_path(
        "V1", v1f, v1_prompts, "decode never writes its K/V",
        lambda: drop_cache_write(v1cf.num_layers, None,
                                 range(v1cf.num_layers)))
    b_ms, b_bytes = decode_bound_ms(v1m)
    v1_rep.update(decode_bound_ms=b_ms, decode_bytes=b_bytes)
    del v1mf, v1, pv1, v1f, pv1f
    gc.collect()
    torch.cuda.empty_cache()

    fe = randn(4, vlc.frontend_tokens, vlc.d_model)
    vt = torch.randint(1, vlc.vocab_size, (4, 1024 - vlc.frontend_tokens),
                       generator=gen, device=dev, dtype=torch.int32)
    # bf16 reported (16 layers of the kernel's bf16 P against the plain
    # version's f32 P move the logits past the budget), then an f32 copy of
    # all 16 layers held
    vlab = (f"forward B=4: {vlc.frontend_tokens} patches + {vt.shape[1]} "
            "text tokens")
    v1_rep["forward_bf16"] = forward_held(
        "V1", v1m, v1c, {"frontend_embeds": fe, "tokens": vt},
        vlab + " bf16", hold=False)
    vfc = dataclasses.replace(v1c, dtype=torch.float32)
    vfm = f32_copy(v1m, vfc)
    del v1m
    v1_rep["forward_f32"] = forward_held(
        "V1", vfm, vfc, {"frontend_embeds": fe, "tokens": vt},
        vlab + " f32")
    del vfm, fe, vt
    gc.collect()
    torch.cuda.empty_cache()

    def train_phase(tag, c, seed, batches, exempt=()):
        """6 AdamW steps (lr 3e-4, warm-up 1) at published widths: the
        loss falls, every parameter moves (``exempt``: weights the batch
        never reads, whose f32 masters must move by the decay alone), no
        kernel and no plain version launched; ms per step, peak GB."""
        m = init_params(c, torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
        before = [p.detach().to("cpu", copy=True) for p in m.parameters()]
        st_ = opt.init(m)
        m0 = {n: st_.master[n].to("cpu", copy=True) for n in exempt}
        step_ = TR.build_train_step(c, opt.AdamWConfig(
            lr=3e-4, total_steps=len(batches), warmup_steps=1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s_, l_ = [], []

        def run():
            for b in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, _, mm = step_(m, st_, b)
                torch.cuda.synchronize()
                s_.append(time.perf_counter() - t)
                l_.append(float(mm["loss"]))
        counted(f"{tag} train {c.name} ({c.num_layers} layers)", (), run,
                forbid=KERNELS)
        check(bool(np.isfinite(l_).all())
              and np.mean(l_[-3:]) < np.mean(l_[:3]),
              f"{tag}: the loss did not fall: {l_}")
        unmoved = [n for (n, p), b in zip(m.named_parameters(), before)
                   if n not in exempt and torch.equal(p.detach().cpu(), b)]
        check(not unmoved, f"{tag}: parameters unchanged: {unmoved[:5]}")
        for n in exempt:
            check(not torch.equal(st_.master[n].cpu(), m0[n]),
                  f"{tag}: the master of {n} did not move")
        ms_ = float(np.median(s_[2:])) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_par = sum(p.numel() for p in m.parameters())
        print(f"[{tag}] train {c.name} ({c.num_layers} layers, "
              f"{n_par / 1e9:.3f} B parameters): loss {l_[0]:.4f} -> "
              f"{l_[-1]:.4f}, {ms_:.2f} ms/step (median of steps 3-"
              f"{len(batches)}), peak {peak:.2f} GB; every parameter moved"
              + (f" ({', '.join(exempt)}: its master, by the decay)"
                 if exempt else "") + ", no kernel launched")
        del m, st_, step_, before
        gc.collect()
        torch.cuda.empty_cache()
        return {"losses": l_, "ms_per_step": ms_, "peak_gb": peak,
                "params": n_par}

    # V1 training, cut to 4 layers: frontend + text batches, B=4, S=1024
    # (576 random patch embeddings ahead of 448 tokens of the synthetic LM
    # stream, whose labels cover the text)
    vtc = dataclasses.replace(vlc, num_layers=4)
    vpipe = SyntheticLMPipeline(4, 1024 - vlc.frontend_tokens, seed=SEED)
    vb = []
    for i in range(6):
        b = device_put_batch(vpipe.get_batch(i), dev)
        b["frontend_embeds"] = randn(4, vlc.frontend_tokens, vlc.d_model)
        vb.append(b)
    v1_rep["train"] = train_phase("V1", vtc, SEED + 121, vb)
    del vb
    print(f"[V1] decode {v1_rep['decode_ms_per_step']:.3f} ms/step against "
          f"a byte bound of {v1_rep['decode_bound_ms']:.3f} ms; phase "
          f"{time.perf_counter() - t_v:.1f} s")
    new_rep["llava-next-mistral-7b"] = v1_rep

    # ---- H1. hubert-xlarge at published widths, all 48 layers ------------
    # ``forward`` on B=4, S=1000 frame embeddings (bidirectional row 4 at
    # D=80) held to the plain op in f32 and in bf16; the engine refuses the
    # encoder; 6 AdamW steps at full depth on a fixed B=2, S=1024 batch
    # whose labels are a function of the frames (the embedding table is
    # never read)
    t_h = time.perf_counter()
    h1_rep: dict = {}
    hm = init_params(hbc, torch.Generator(device=dev).manual_seed(
        SEED + 140), device=dev)
    hcf = dataclasses.replace(hbc, dtype=torch.float32)
    hmf = f32_copy(hm, hcf)
    hx = randn(4, 1000, hbc.d_model)
    for dt_tag, c_, m_, x_ in (("bf16", hbc, hm, hx),
                               ("f32", hcf, hmf, hx.float())):
        h1_rep[f"forward_{dt_tag}"] = forward_held(
            "H1", m_, c_, {"frontend_embeds": x_},
            f"forward {dt_tag} B=4 S=1000 (bidirectional, D=80)")
    try:
        InferenceEngine("H1", hbc, hm, ucfg)
        fail("H1: an engine over the encoder was built")
    except NotImplementedError as e:
        print(f"[H1] InferenceEngine refuses the encoder: {e}")
    del hm, hmf, hx, c_, m_, x_
    gc.collect()
    torch.cuda.empty_cache()
    # training attends through chunked_attention, whose spans are whole
    # 512-query blocks (as the reference's): S=1024; B=2 (B=4 peaked at
    # 69.5 GB, the saved attention chunks of 48 layers)
    hx = randn(2, 1024, hbc.d_model)
    proj = randn(hbc.d_model, hbc.vocab_size, dtype=torch.float32)
    hlab = (hx.float() @ proj).argmax(-1).to(torch.int32)
    hb = {"frontend_embeds": hx, "labels": hlab,
          "loss_mask": torch.ones(hlab.shape, device=dev)}
    h1_rep["train"] = train_phase("H1", hbc, SEED + 141, [hb] * 6,
                                  exempt=("embed",))
    del hx, proj, hlab, hb
    h1_rep["phase_s"] = time.perf_counter() - t_h
    print(f"[H1] phase {h1_rep['phase_s']:.1f} s")
    new_rep["hubert-xlarge"] = h1_rep

    # ---- S1. session checkpoints on the probe (smollm-135m, 30 layers) ----
    # for each pair of source and destination engines (paged or
    # monolithic): ``generate`` with ``return_state``, checkpoint, the
    # source continues with a new span (the uninterrupted chat), a fresh
    # destination engine restores and continues with the same span:
    # tokens, logits and u bitwise.  paged -> paged runs the block-table
    # route; a paged engine beside a monolithic one runs the gathered view
    # (bitwise the monolithic engine by construction).  Then a sampled
    # session's stream, and an int8 checkpoint refused by a bf16 engine
    t_s = time.perf_counter()
    from repro_torch.serving.cache_manager import QuantMismatchError
    s1m = init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 130), device=dev)
    s_rng = np.random.default_rng(SEED + 130)
    s_span = s_rng.integers(1, cfg.vocab_size, (8, 12)).astype(np.int32)
    ses_root = ROOT / "build" / "chip_smoke_sessions"
    shutil.rmtree(ses_root, ignore_errors=True)
    ses_root.mkdir(parents=True)
    s1_rep: dict = {}

    def s1_engine(kind, name, cross=False, **kw):
        if kind == "paged":
            kw = dict(paged=True, pool_blocks=256, **kw)
            if cross:
                kw["attn_decode_impl"] = "gather"
        return InferenceEngine(name, cfg, s1m, ucfg, **kw)

    def s1_needs(kind, cross):
        return PAGED_SERVE if kind == "paged" and not cross else \
            SERVE_KERNELS

    try:
        for src, dst in (("paged", "paged"), ("paged", "mono"),
                         ("mono", "paged"), ("mono", "mono")):
            cross = src != dst
            d = str(ses_root / f"{src}-{dst}")
            e1 = s1_engine(src, f"S1-{src}", cross)
            st = e1.generate(prompts, 16, return_state=True)["state"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = e1.checkpoint_session(st, d)
            t_save = time.perf_counter() - t0
            nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
            ref = counted(f"S1 {src} uninterrupted continuation",
                          s1_needs(src, cross),
                          lambda: e1.generate(s_span, 16, state=st))
            e2 = s1_engine(dst, f"S1-{dst}-restored", cross)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st2 = e2.restore_session(d)
            torch.cuda.synchronize()
            t_rest = time.perf_counter() - t0
            got = counted(f"S1 {src}->{dst} restored continuation",
                          s1_needs(dst, cross),
                          lambda: e2.generate(s_span, 16, state=st2))
            check(np.array_equal(got["tokens"], ref["tokens"])
                  and torch.equal(got["logits"], ref["logits"])
                  and np.array_equal(got["u"], ref["u"]),
                  f"S1 {src}->{dst}: the restored chat differs from the "
                  "uninterrupted one")
            print(f"[S1] {src} -> {dst}: checkpoint {nbytes / 1e6:.1f} MB, "
                  f"save {t_save:.3f} s, restore {t_rest:.3f} s; the "
                  "restored continuation is bitwise the uninterrupted one")
            s1_rep[f"{src}->{dst}"] = {"bytes": nbytes, "save_s": t_save,
                                       "restore_s": t_rest}
            del e1, e2, st, st2
        # a sampled session continues its stream (the generator's state)
        e1 = s1_engine("mono", "S1-sampled")
        st = e1.generate(prompts, 16, greedy=False, seed=5,
                         return_state=True)["state"]
        e1.checkpoint_session(st, str(ses_root / "sampled"))
        ref = e1.generate(None, 16, state=st, greedy=False)
        e2 = s1_engine("mono", "S1-sampled-restored")
        got = e2.generate(None, 16, greedy=False, state=e2.restore_session(
            str(ses_root / "sampled")))
        check(np.array_equal(got["tokens"], ref["tokens"])
              and torch.equal(got["logits"], ref["logits"]),
              "S1: the restored sampled session left its stream")
        print("[S1] sampled session: the restored extension is bitwise the "
              "uninterrupted one")
        # an int8 pool's checkpoint refused by a bf16 paged engine
        q8 = s1_engine("paged", "S1-int8", cache_quant="int8")
        st = q8.generate(prompts, 4, return_state=True)["state"]
        q8.checkpoint_session(st, str(ses_root / "int8"))
        e2 = s1_engine("paged", "S1-bf16")
        try:
            e2.restore_session(str(ses_root / "int8"))
            fail("S1: an int8 checkpoint restored on a bf16 engine")
        except QuantMismatchError as e:
            print(f"[S1] int8 checkpoint on a bf16 engine: "
                  f"QuantMismatchError ({str(e)[:80]}...)")
        del e1, e2, q8, st, ref, got
    finally:
        shutil.rmtree(ses_root, ignore_errors=True)
    del s1m
    gc.collect()
    torch.cuda.empty_cache()
    s1_rep["phase_s"] = time.perf_counter() - t_s
    print(f"[S1] phase {s1_rep['phase_s']:.1f} s")
    new_rep["sessions"] = s1_rep
    new_rep["phase_s"] = time.perf_counter() - t_new
    print(f"[X] X0-S1 {new_rep['phase_s']:.1f} s")
    report["new_archs"] = new_rep

    # ---- T1. training at published width --------------------------------
    t_phase = time.perf_counter()
    held_gb = torch.cuda.memory_allocated() / 1e9   # left by phases 1-8
    # the reference CLI's AdamW (lr 3e-4, warm-up a tenth of the steps),
    # batch 8, seq 128; the loss and no kernel through all 10 steps, then
    # two profiled steps for the device's busy share
    n_train = 10                 # cut from 30 for the script's time
    train_rep: dict = {}
    t4_snap: dict = {}
    for arch, layers in (("smollm-135m", None), ("llama3-8b", 4)):
        tcfg = configs.get_config(arch)
        if layers is not None:
            tcfg = dataclasses.replace(tcfg, num_layers=layers)
        tmodel = init_params(tcfg, torch.Generator(device=dev).manual_seed(
            SEED + 30), device=dev)
        before = [p.detach().clone() for p in tmodel.parameters()]
        tstate = opt.init(tmodel)
        step_fn = TR.build_train_step(tcfg, opt.AdamWConfig(
            lr=3e-4, total_steps=n_train, warmup_steps=max(n_train // 10, 1)))
        pipe = SyntheticLMPipeline(8, 128, seed=SEED)
        batches = [device_put_batch(pipe.get_batch(i), dev)
                   for i in range(n_train + 2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s, losses, gnorms = [], [], []

        def train_run():
            for i in range(n_train):
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, _, m = step_fn(tmodel, tstate, batches[i])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                losses.append(m["loss"])
                gnorms.append(m["grad_norm"])
                if i + 1 == T4_STEPS and arch == "llama3-8b":
                    # T4 (1, 1) holds its mesh steps to these
                    t4_snap["params"] = {
                        n: p.detach().clone()
                        for n, p in tmodel.named_parameters()}
                    t4_snap["metrics"] = [(float(a), float(b)) for a, b in
                                          zip(losses, gnorms)]

        counted(f"train {tcfg.name}", (), train_run, forbid=KERNELS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = torch.stack(losses).tolist()
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        check(bool(np.isfinite(losses).all()) and last < first,
              f"T1 {tcfg.name}: the loss did not fall ({first} -> {last})")
        same = [n for (n, p), b in zip(tmodel.named_parameters(), before)
                if torch.equal(p.detach(), b)]
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
        # the same steps without remat (each layer's forward kept for the
        # backward instead of recomputed): 3 more steps
        nr_fn = TR.build_train_step(dataclasses.replace(tcfg, remat=False),
                                    opt.AdamWConfig(
            lr=3e-4, total_steps=n_train, warmup_steps=max(n_train // 10, 1)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nr_s = []
        for i in range(3):
            t = time.perf_counter()
            nr_fn(tmodel, tstate, batches[i])
            torch.cuda.synchronize()
            nr_s.append(time.perf_counter() - t)
        nr_ms = float(np.median(nr_s[1:])) * 1e3
        nr_peak = torch.cuda.max_memory_allocated() / 1e9
        # and 3 with each layer recomputed through torch.utils.checkpoint
        # (its hooks on every saved tensor) in place of transformer._Remat
        ck_s = remat_by_checkpoint(step_fn, tmodel, tstate, batches[:3])
        ck_ms = float(np.median(ck_s[1:])) * 1e3
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
        print(f"[T1] {tcfg.name}: remat (cfg.remat, each layer "
              f"recomputed in the backward) {ms:.2f} ms/step, peak "
              f"{peak_gb:.2f} GB; without remat {nr_ms:.2f} ms/step, peak "
              f"{nr_peak:.2f} GB; remat through torch.utils.checkpoint "
              f"{ck_ms:.2f} ms/step")
        for us, key, n in top:
            print(f"[T1]   2 steps: {us / 1e3:9.3f} ms in {n:5d} x "
                  f"{key[:70]}")
        train_rep[tcfg.name] = {
            "layers": tcfg.num_layers, "weights_in_products": n_prod,
            "losses": losses, "ms_per_step": ms,
            "tokens_per_s": tokens / ms * 1e3, "model_tflops": tflops,
            "peak_gb": peak_gb, "no_remat_ms_per_step": nr_ms,
            "no_remat_peak_gb": nr_peak, "checkpoint_ms_per_step": ck_ms,
            "step_device_ms": dev_us / 2 / 1e3,
            "busy_share": busy,
            "profile_top_2steps": [(us / 1e3, key, n) for us, key, n in top]}
        del tmodel, tstate, batches, step_fn, prof
        torch.cuda.empty_cache()
    t_t1 = time.perf_counter() - t_phase
    print(f"[T1] phase {t_t1:.1f} s")
    report["train"] = dict(train_rep, phase_s=t_t1, held_gb=held_gb)

    # ---- T4 (1, 1). T1's llama3-8b steps on the (1, 1) NCCL mesh ---------
    t_phase = time.perf_counter()
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.models.transformer import shard_params
    t4_mesh = serving_mesh(device=dev)
    tcfg = dataclasses.replace(configs.get_config("llama3-8b"), num_layers=4)
    whole = init_params(tcfg, torch.Generator(device=dev).manual_seed(
        SEED + 30), device=dev)
    t4_comm = sh.Comm(t4_mesh)
    tshard = shard_params(whole, tcfg, t4_mesh, t4_comm,
                          rules=sh.DEFAULT_RULES)
    check(all(not (c_.tp_axes or c_.dp_axes)
              for c_ in tshard.cuts.values()),
          "T4 (1, 1): the (1, 1) mesh cut a leaf")
    tstate = opt.init(tshard)
    mstep = TR.build_train_step(tcfg, opt.AdamWConfig(
        lr=3e-4, total_steps=n_train, warmup_steps=max(n_train // 10, 1)),
        t4_mesh)
    pipe = SyntheticLMPipeline(8, 128, seed=SEED)
    t4_batches = [device_put_batch(pipe.get_batch(i), t4_mesh, dev)
                  for i in range(T4_STEPS)]
    t4_got, t4_s = [], []

    def t4_run11():
        for b in t4_batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, m = mstep(tshard, tstate, b)
            torch.cuda.synchronize()
            t4_s.append(time.perf_counter() - t)
            t4_got.append((float(m["loss"]), float(m["grad_norm"])))

    counted("train llama3-8b on the (1, 1) mesh", (), t4_run11,
            forbid=KERNELS)
    check(t4_comm.stats["all_reduce"] + t4_comm.stats["all_gather"]
          + t4_comm.stats["agree"] == 0,
          f"T4 (1, 1): collectives issued: {t4_comm.stats}")
    check(t4_got == t4_snap["metrics"],
          f"T4 (1, 1): losses and grad norms {t4_got} differ from T1's "
          f"{t4_snap['metrics']}")
    differ11 = [n for n, p in tshard.named_parameters()
                if not torch.equal(p.detach(), t4_snap["params"][n])]
    check(not differ11, f"T4 (1, 1): {len(differ11)} parameters differ "
                        f"from T1's after {T4_STEPS} steps: {differ11[:4]}")
    ms11 = float(np.median(t4_s[1:])) * 1e3
    ms1 = train_rep[tcfg.name]["ms_per_step"]
    print(f"[T4] (1, 1) NCCL mesh: llama3-8b (4 layers, bf16, B=8, S=128) "
          f"{T4_STEPS} steps of build_train_step(mesh) bitwise T1's "
          f"one-device steps (losses, grad norms, all "
          f"{len(t4_snap['params'])} parameters), no collective, no kernel "
          f"and no plain version; {ms11:.2f} ms/step vs T1's {ms1:.2f}")
    report["t4"] = dict(ctx_t4, mesh11={
        "ms_per_step": ms11, "one_device_ms_per_step": ms1,
        "metrics": t4_got, "phase_s": time.perf_counter() - t_phase})
    del whole, tshard, tstate, mstep, t4_batches, t4_snap
    torch.distributed.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

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
        args = ["--arch", "smollm-135m", "--steps", str(T2_STEPS), "--batch",
                "8", "--seq", "128", "--ckpt-every", str(T2_STEPS // 2),
                "--ckpt-dir"]
        d1, d2 = str(ck_root / "straight"), str(ck_root / "restarted")
        # the straight run and the resumed one in this process (``main``
        # is the CLI's body: no interpreter start), the killed run as the
        # CLI in a process of its own, started first: a thread kills it
        # once it has published its checkpoint at half while this process
        # runs the straight run
        half = T2_STEPS // 2
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train"] + args + [d2],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)

        def watch():
            for line in proc.stdout:
                if line.startswith(f"[train] checkpoint @ {half}"):
                    proc.kill()
                    return

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            t1 = time.perf_counter()
            train_mod.main(args + [d1])
            torch.cuda.synchronize()
            t_straight = time.perf_counter() - t1
            watcher.join(timeout=400)
        finally:
            proc.kill()
            proc.wait(timeout=60)
            watcher.join(timeout=10)
            proc.stdout.close()
        check(ck.latest_step(d2) == half,
              f"T2: the killed run left checkpoint {ck.latest_step(d2)}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_mod.main(args + [d2, "--resume"])
        torch.cuda.synchronize()
        t_restart = time.perf_counter() - t0
        check(f"[train] resumed from step {T2_STEPS // 2}" in out.getvalue(),
              f"T2: the resumed run did not resume: {out.getvalue()[-1000:]}")
        a, _ = ck.load_leaves(d1, T2_STEPS)
        b, _ = ck.load_leaves(d2, T2_STEPS)
        check(sorted(a) == sorted(b), "T2: the checkpoints hold other leaves")

        def bits(x):
            if isinstance(x, int):
                return torch.tensor([x])
            return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                           8: torch.int64}[x.element_size()])

        differ = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        check(not differ, f"T2: step_{T2_STEPS} of the restarted run "
                          f"differs from the straight run's in {len(differ)} "
                          f"leaves: {differ[:5]}")
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)
    print(f"[T2] checkpoint of smollm-135m + AdamW state: {ck_bytes / 1e9:.3f}"
          f" GB, save {t_save:.2f} s, restore {t_restore:.2f} s; CLI "
          f"{T2_STEPS} steps straight {t_straight:.1f} s (in process, beside "
          f"the killed run's start), killed at step {T2_STEPS // 2} (its own "
          f"process) and resumed (in process) {t_restart:.1f} s from its "
          f"start: step_{T2_STEPS} bitwise equal in all {len(a)} leaves")
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
        tgw, tprobe, tcloud, tworld = serve_mod.build_gateway(
            train_steps=T3_STEPS)
        t_build = time.perf_counter() - t0
    finally:
        serve_mod.train_lm, serve_mod.train_safety = orig_lm, orig_safety
    for name, ls in tier_losses.items():
        check(bool(np.isfinite(ls).all()) and ls[-1] < ls[0],
              f"T3: {name} loss {ls[0]} -> {ls[-1]}")
    print(f"[T3] build_gateway(train_steps={T3_STEPS}): {t_build:.1f} s; "
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
            "launches_d3": {
                "mesh11": sum(n[name] for p, n in path_launches.items()
                              if p.startswith("mesh11 D3 ")),
                "ranks": sum(x["launches"][name] for j in report[
                    "mesh_d3"]["ranks"].values() for x in j["per_rank"])},
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]})
    report["kernels"] = kernels
    report["path_seconds"] = path_seconds
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
