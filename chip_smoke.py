#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernels.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It needs one CUDA GPU, ``nvcc`` and the repository's ``src/`` beside it,
and exits nonzero (printing no result) without them.  Phases, one line
each on standard output (the per-shape details go to standard error):

1. device: name and power limit (``nvidia-smi``), torch/CUDA versions,
   and the seconds to build the six kernels (one ``nvcc`` each, in
   parallel); ``crossbar_gemm``'s SASS must hold int8 tensor-core
   (``IGMMA``) instructions and no ``IDP.4A`` or ``POPC``, and
   ``fused_gemm_epilogue``'s and ``packed_gemm``'s float tensor-core ones
   (``HMMA``, or ``HGMMA``);
2. ``crossbar_gemm`` exact branch, equal to the plain version
   (``torch.equal``): ResNet-18's stage shapes (batch 16) in the main
   path's form (x in the kernel layout, the packed ``wt``), ragged
   shapes, M in 1/4/16 x K in 27/101/988/1458/4860 x N in 10/19/77,
   all -128 operands, and the K split on and off for one shape (all on
   the 64 x 64 tiles); then the wide tiles (``WIDE_CASES``: 2-D calls
   that fill the card, each of the four widths, ragged M, N and K) in
   the main path's form, each under its wide plan and one launch;
3. ``crossbar_gemm`` sliced branch (8-bit ADC / 494 rows, 9-bit / 512,
   every chunk height 247/486/494/511/512 at M = 1, 4, 16) on inputs
   where clips fire, all -1 operands, and the chunk split on and off,
   equal to the plain version;
4. ``fb_epilogue`` in every mode against the plain version, to the
   tolerances in ``FB_CASES`` (``torch.equal`` where the tolerance is 0),
   at each mode's own width and at N = 64/192/768 (16-byte path) and
   10/19/77 (scalar path), the row modes also at N = 1024 (a warp per
   row) and 1025 (a block per row);
5. the main path: ``repro_torch.api.compile("resnet18", HurryConfig())``
   at full width, serving request batches of 1, 3 and 16, checked
   against the same weights run on the CPU's plain path; the three
   program kernels' launch counters (``quantize_layout``,
   ``crossbar_gemm``, ``fb_epilogue``: ``PROGRAM_KERNELS``) must each grow
   by one per stage and forward, ``quantize_layout`` by two per dynamic
   stage (``forward_launches``; ``run`` warms each key up eagerly at its
   first request, captures a CUDA graph and replays it: the counters
   count the warm-up and each replay, ``program.serve.Executable``);
6. the sliced branch end to end: AlexNet under ``HurryConfig(adc_bits=8)``
   at batch 4 against the CPU's plain path;
7. times: each kernel summed over one batch-16 forward's shapes, and
   the GEMM over a batch-1 forward's as well (device time per call from
   25 calls captured in a CUDA graph, median of 5 replays,
   ``device_ms``), beside its bound, its plain version and, for the GEMM,
   ``torch._int_mm`` with the weight row-major and K-major; the five
   stages furthest from their bound at each batch, for the GEMM and for
   ``fb_epilogue``; the wide tiles at vit_s16's b1024 fc1 (``WIDE_TIMED``)
   beside its bound, its plain version and ``torch._int_mm`` K-major; and
   ResNet-18's end-to-end time per batch at 1 and 16 (host clock around
   ``run``, a graph replay, and a device synchronize, median of 10), with
   the device's busy time (profiler device events) and idle share of
   those forwards (``forward_profile``);
8. the batched launches at vit_tiny's dynamic shapes (48 slices of
   64x64x64): ``crossbar_gemm`` on both branches and ``fb_epilogue``
   (scores: softmax + post_scale; context: plain dequant) in one launch
   each, equal to the plain versions on the same inputs and to the
   per-slice 2-D calls (``torch.equal``; softmax to 1e-6), also in the
   executor's forms (``crossbar_gemm`` on ``wt`` and K alone,
   ``fb_epilogue`` with no bias and the context's heads merged on
   store), and 5 ragged slices of 16x1001x19 through a mounted weight;
9. ``flash_attention`` against its plain version: float32 at
   (1,128,1,64) and (2,256,4,64) causal and not, a 128-key window at
   (1,512,2,64), vit's (16,64,3,64), the attention path's (1,T,4,16) for
   T = 16, 64, 256, head dims 16/32/128, a ragged last key tile, head
   dims below their instantiation and rows that are not 16-byte aligned,
   and shapes on both sides of the key-split threshold, to 1e-4; bfloat16
   at every head dim and (1,512,4,64) to 2e-2; the key split forced off
   and on at (1,512,4,64), two runs of the split ``torch.equal``, and the
   merged output against the split's plain version
   (``flash_attention_split_ref``); GQA through ``ops.attention`` at
   (1,256,8,64) with 2 kv heads;
10. ``fused_gemm_epilogue`` against its plain version at 128x256x128,
    256x512x384, 128x1024x256 and 256x512x256 and the ragged, unaligned
    1x7x3, 77x1001x19 and 130x514x258, every activation, with and
    without residual, float32 (1e-4) and bfloat16 (2e-2); at 256x512x256
    the K split forced off and left on, two split runs ``torch.equal``;
11. ``packed_gemm`` against its plain version, and ``ops.grouped_gemm``
    against ``packed_gemm_ref``, for the group sizes of
    ``tests/test_kernels.py`` (the second is the kernel bench's case),
    K=128, N=256, and at block_m 32/64/96 with the tile map [2, 0, 2, 1],
    float32 (1e-4) and bfloat16 (2e-2);
12. the sequence path: ``repro_torch.api.compile("vit_tiny")`` at full
    width (dim 192, 3 heads, depth 2, 64 tokens) serving batches 1, 3
    and 16 against the CPU plain path (argmax agreement 1.0, logits to
    a relative 1e-2, probabilities to 1e-3); every
    dynamic stage makes exactly two ``quantize_layout`` launches (its
    right operand, then its left one with the requant factor), one
    ``crossbar_gemm`` and one ``fb_epilogue`` launch (read from each
    key's warm-up); time per
    batch at 1 and 16 and the device's
    idle share, as in 7; then batch 16 on three further input draws
    (``VIT_DRAWS``), each draw's max relative logit gap and argmax
    agreement printed, and on the draw with the largest gap every stage
    teacher-forced on the card from the CPU path's buffers (int32 GEMM
    outputs ``torch.equal``, FB outputs within ``FB_CASES``' tolerances)
    and the int8 GEMM operands of the free-running forward that differ
    from the CPU path's, stage by stage (standard error);
13. the attention path: one ``attention(4)`` layer (dim 64, batch 1,
    ``HurryConfig(array_rows=511)``) at T = 16, 64, 256 through
    ``api.compile(...).run``, against ``ops.attention(causal=False)``
    on the same projected q/k/v followed by the same output projection
    (relative error < 0.12, correlation > 0.99), with both times;
14. the ops entry point: ``repro_torch.kernels.ops``' five wrappers at
    the kernel bench's shapes, each launching its kernel once and
    agreeing with its plain version;
15. times of the new kernels and of vit_tiny's dynamic stages, as in 7,
    with ``F.scaled_dot_product_attention`` as the attention yardstick;
    ``flash_attention`` also at ``FLASH_TIMED`` (float32 (1,512,4,64)
    causal and not, (16,64,3,64), bfloat16 (1,512,4,64) causal and not),
    each beside SDPA; ``fused_gemm_epilogue`` and ``packed_gemm`` at
    ``FUSED_TIMED`` / ``PACKED_TIMED`` (the kernel bench's shapes and
    2048x2048x2048 / 8 ragged groups of 4096 rows, K 1024, N 1024), in
    float32 and bfloat16, beside ``torch.addmm`` (bias only; for ReLU also
    ``torch._addmm_activation``, the same function), a per-group
    ``torch.matmul`` loop and ``torch._grouped_mm`` where this torch takes
    the case;
16. VGG-16: ``api.compile("vgg16", HurryConfig())`` at full width
    serving batches 1 and 16 (probabilities and logits), logits
    ``torch.equal`` to the CPU plain path's, the three counters one launch per
    stage and request, and its time per batch;
17. save/load: ResNet-18 and vit_tiny (compiled on the card) saved to a
    temporary file and ``api.load``-ed onto the card, batch 16 equal to
    the in-memory model (``torch.equal``); the seconds of a fresh
    ``compile`` beside ``load``, and the file's size;
18. ``make_server("resnet18")`` at batches 1, 3 and 16 ``torch.equal`` to
    ``CompiledModel.run``, one launch of each kernel per stage and
    request, and its time per batch beside ``run``'s;
19. the functional model: ``crossbar_matmul`` on both branches (ragged K,
    leading dims, a slice axis, operands outside int8) ``torch.equal`` to
    the CPU with one ``crossbar_gemm`` launch per call; the read-noise
    statistic on the card within 15% of the CPU's at sigma 0.5 and 2.0;
    ``graph.forward(mm=make_crossbar_matmul(cfg))`` for ResNet-18 and
    vit_tiny at batch 16 against the same call on the CPU (ResNet-18 as 5
    holds ``run``: argmax 1.0 and a relative 1e-4; vit_tiny to 12's
    ``VIT_REL`` and ``VIT_PROB_ATOL``, its argmax agreement printed with
    the CPU's top-two margin of each flipped row, not held: a near-tied
    row flips under the devices' ulp-level differences), its launches,
    and its time per batch beside ``run``'s;
20. ``simulate``: ResNet-18's ``SimReport.summary()`` on every arch of
    ``SIM_ARCHS`` (host only);
21. the LM serving stack (``repro_torch.models.lm``, ``serve``), plain
    PyTorch like the JAX package's plain ``jnp``: (a) all ten archs at
    ``reduced()``, and Mixtral with its window cut to 8 decoding 24
    steps through its ring buffer, on the card against the CPU on the
    same float32 weights (forward, Whisper's ``encode`` and 16
    teacher-forced ``decode_step``s within 1e-4 of max |logit|); (b)
    Qwen3-8B at full width, depth 2, float32, batch 2 x 64, forward on
    the card against the CPU to 1e-4; (c) Qwen3-8B at full width and
    its 36 layers, float32 parameters: 128 teacher-forced decode steps
    against the forward in float32 compute (argmax agreement > 0.95 and
    correlation > 0.98, ``tests/test_archs_smoke.py``'s thresholds) and
    in bfloat16 (correlation > 0.98, agreement printed); (d) the same model with bfloat16 parameters served:
    ``make_prefill_step`` at batch 1 x 4096 (the chunked attention) and
    ``greedy_generate`` at batch 8 (128-token prompt, 64 new tokens),
    the prefill's and a decode step's times (``wall_ms``, median of 5)
    and tokens/s beside their floors, with the device's busy time; the
    same greedy loop's 191 steps through ``compile_decode_step`` beside
    the eager step on the same inputs, ids and logits ``torch.equal``
    (``decode_replay``), and one replayed step's time, busy time, idle
    share, tokens/s and capture seconds beside the eager step's; (e)
    ``quantize_kv`` on the card ``torch.equal`` to the CPU; (f) no
    launch of any of the six kernels across the phase;
22. the LM training path (``repro_torch.train``, ``data``,
    ``launch.train``): (a) all ten archs at ``reduced()``, float32
    weights, batch 2 x 16, on the card against the CPU: the float32-
    compute loss within 1e-5 relative and every gradient leaf within 1e-4
    of that leaf's max |grad|, and one ``make_train_step`` step (bfloat16
    compute, remat) whose gradients correlate at 0.99 or more; then
    ``TRAIN_REPLAY['steps']`` steps through ``compile_train_step`` (one
    CUDA graph per key: the first step eager, the second captured and
    replayed, the third replayed) beside the eager ``make_train_step``
    from the same state (and InternLM2 with ``microbatches=2``): the
    final parameters, ``m``, ``v``, ``step`` and every step's metrics
    ``torch.equal`` to the eager run's, or, where they are not, within
    ``REPLAY_GAP_FACTOR`` times the gap of a second eager run to the
    first (both printed); (b) InternLM2-1.8B at full width, depth 2, b1 x
    256, loss and gradients against the CPU at (a)'s tolerances,
    ``remat=True`` against ``remat=False`` on the card to 1e-6 of max
    |grad| (``torch.equal`` printed), ``microbatches=2`` against 1 at b2
    (correlation 0.99); (c)
    InternLM2-1.8B at full width and its 24 layers, 1.89 B float32
    parameters with AdamW state, trained 8 remat steps at b1 x 4096 from
    ``TokenPipeline(seed=11)`` with ``OptimizerConfig(lr=1e-3)``: finite
    losses, ``step == 8``, every leaf moved; each step's loss and
    ``grad_norm``, the step time (host clock + synchronize, median of
    the last 5), tokens/s and the floor worked out from the code
    (``train_step_flop`` over the bf16 peak plus the optimizer's bytes
    over HBM), peak memory, one step's device busy time, idle share and
    largest kernels, the optimizer's time alone and one layer's attention
    core (``mha_chunked`` as remat runs it) for its elementwise share;
    then the same 8 steps from the same state through
    ``compile_train_step`` (the eager run's final state on the host
    meanwhile), held as (a) holds it (a second eager run only where the
    replay differs), the replayed step's time, busy time, idle share,
    tokens/s, capture seconds and peak memory beside eager's; (d)
    ``python -m repro_torch.launch.train --reduced`` 20 steps, then
    relaunched to 30 in the same temporary directory (it resumes),
    against a fresh 30-step run through ``main`` here, to 1e-4 of max
    |param| (``torch.equal`` printed), each process one capture of the
    compiled step; (e) no launch of any of the six kernels across
    (a)-(c) and (d)'s fresh run;
23. the LM framework's sharding (``repro_torch.sharding``) and mesh
    dry-run (``launch.{mesh,cost,dryrun,roofline}``): (a) a 1-rank NCCL
    group and ``make_local_mesh("cuda")``, Qwen3-8B at full width and
    depth 2 as DTensors under the active rules: the bfloat16 prefill at
    b2 x 64 against the plain path (1e-4 of max |logit|; ``torch.equal``
    printed) and 16 float32 decode steps through the sequence-sharded
    flash decode against the plain decode (2e-4 of max |logit|, the first
    layer's cache ``torch.equal``, both layers' within 2e-4 of max),
    InternLM2-1.8B at depth 2, b1 x 256: float32 loss and gradients at
    phase 22's tolerances and one bfloat16 ``make_train_step`` step's
    parameters against the plain path; (b) ``python -m
    repro_torch.launch.dryrun --arch qwen3_8b`` at full size for
    ``train_4k``, ``decode_32k`` and ``--multi-pod train_4k`` on the fake
    256- and 512-rank worlds, in three processes at once, each ``ok``,
    their JSON lines, seconds and roofline table (data-sheet constants: a
    model of an H100 cluster); (c) ``launch.cost.Counter`` under
    ``FakeTensorMode`` over InternLM2-1.8B's remat train step and
    Qwen3-8B's prefill at b1 x 4096, within 5% of phases 22 (c)'s and 21
    (d)'s hand counts, their roofline times printed beside the measured
    step and prefill; no launch of any of the six kernels across (a) and
    (c);
24. the examples and the entry points a user starts, each with no
    ``--device`` (the card is the default): (a)
    ``examples/quickstart_torch.py`` for AlexNet at batch 2 as a
    subprocess (``bit-exact=True`` twice), then through ``main`` for
    ResNet-18 and the custom net (bit-exact and the save/load round trip
    ``True``) and vit-tiny (logits and probabilities within the
    example's ``SEQ_REL`` / ``SEQ_PROB_ATOL``, which are 12's
    ``VIT_REL`` / ``VIT_PROB_ATOL``; the kernel's GELU, layer norm and
    softmax round in another order than ``graph.forward``'s), one
    launch of each kernel per stage in ``run``, and the simulate table;
    (b) ``examples/crossbar_inference_torch.py`` for AlexNet and
    ResNet-18 at batch 8 on the card and on the CPU: clean crossbar
    logits argmax 1.0 and ``XBAR_REL``, the noisy run's relative error
    within ``NOISE_REL`` of the CPU's, one ``crossbar_gemm`` launch per
    GEMM clean and none noisy, the branch of each GEMM and the forwards'
    times; (c) ``examples/serve_lm_torch.py`` for ``SERVE_ARCHS`` on the
    card (through the compiled decode step: ids and logits
    ``torch.equal`` to the same loop through the eager step on the card)
    and on the CPU, continuation ids equal up to the first step
    whose CPU top-two margin is under ``TIE`` of max |logit| (that step
    and margin printed; bfloat16 logits tie exactly at times), and the
    example's loop in float32 likewise with every step's logits within
    ``LM_TOL``, bfloat16 tokens/s beside the eager step's, no launch of
    the six kernels, then ``python -m repro_torch.launch.serve --rounds
    2``: one capture over both rounds; (d)
    ``examples/train_lm_torch.py`` (100M, b8 x 256) ``--steps 60
    --ckpt-every 20`` killed with SIGKILL once step 40 is committed and
    rerun to 60 (it resumes), against an uninterrupted run through
    ``main`` to ``TRAIN_RESUME_TOL`` of max |param| (``torch.equal``
    printed, not held: a backward with atomics may reorder sums), both
    through the compiled train step (one capture per process), ms per
    step, tokens/s and peak memory; (e) ``python -m
    repro_torch.launch.train --reduced`` sent SIGTERM after its first
    step line: it saves the step it reached and exits 0; relaunched, it
    resumes to ``SIGTERM_STEPS``, against an uninterrupted run at (d)'s
    tolerance; (f) ``api.load`` of a version-1 file (parameters only)
    onto the card, the repack there, batch 16 ``torch.equal`` to the
    in-memory ResNet-18; (g) ``program.execute_program`` on ResNet-18 at
    batch 16 ``torch.equal`` to ``execute_packed``, one launch of each
    kernel per stage, both times.  (b)'s CPU references run in a thread
    beside (d)'s two subprocesses (whose times are not kept);
25. crossbar programs at other widths (``WIDTHS``: 4- to 8-bit operands,
    5- to 8-bit ADCs, 512/256/128-row arrays): (b) the sliced branch at
    adc 5/6/7 x rows 128/256 (``NARROW``) against its plain version, M
    1/4/16, a K of 40 chunks (split by chunk, and forced unsplit), all -1
    operands, clips where ``clip_possible`` says; (a) ResNet-18 b16 and
    AlexNet b4 compiled on the card at every width, ``torch.equal`` to
    the CPU plain path (computed in a worker thread meanwhile), each
    stage on the branch ``clip_possible(min(rows, K), adc_bits)``
    predicts (read from the stage's captured launch, once per model),
    the three counters one launch per stage, µs per batch beside the
    8/8/9 default's; vit_tiny b16 at ``w4a4_adc6``: every stage
    teacher-forced from the CPU path's buffers (held as in 12), its
    branches, the free run against the CPU (12's ``VIT_REL`` /
    ``VIT_PROB_ATOL``), time per batch;
26. every LM family at its published width (plain PyTorch): (a) the nine
    archs other than Qwen3-8B at full width, the depth cut to one of every
    block kind (``WIDE_CUTS``), float32 weights drawn on the card, forward
    b2 x 64 and 8 teacher-forced decode steps against the CPU on a copy
    of the weights (``LM_TOL``; each CPU side in a worker thread while the
    next arch runs on the card; (a) itself runs while 25's CPU references
    finish); (b) the five whose bfloat16 weights fit
    one card (``SERVED``) at full width and depth: 32 teacher-forced
    decode steps against the forward (float32 compute: 21 (c)'s
    thresholds, MoE ``MOE_CORR`` with its agreement printed; bfloat16:
    correlation, printed for ``BF16_DRIFT``),
    ``make_prefill_step`` at b1 x 2048 (Whisper: 64 tokens over 1500
    frames), ``greedy_generate`` at b4 (64-token prompt, 32 new) and a
    decode step timed beside floors worked out from the code's work
    (``lm_flop``), with busy time and idle share; the greedy loop through
    ``compile_decode_step`` beside the eager step as 21 (d) (MoE beside a
    second eager loop too: where two eager loops differ, the replay is
    held to ``REPLAY_GAP_FACTOR`` times their gap), its replayed step
    timed and profiled (xLSTM's prefill
    profiled at ``PROFILED_PREFILL``'s 256 tokens, beside that length's
    own wall time: its sLSTM launches some 10^5 kernels at 2048), the
    init and serving
    peaks; part 3, the int8 KV cache at the served Qwen3-8B cache's shape
    on a 16-slot ring (``KV_RING``): every field of every update and
    ``read_quant_cache`` ``torch.equal`` card against CPU, ``_decode_mha``
    over it within ``KV_ATTN_TOL`` of the float32 ring's; (c) no launch of
    the six kernels across the phase.  To run 25-26 alone, drive
    ``widths_phase`` and ``lm_wide_phase`` from a script under ``build/``
    after the kernel build;
27. the front door's executable per key: ResNet-18, AlexNet at
    ``adc_bits=8``, VGG-16, vit_tiny and the pre-norm ViT-S/16 at its
    published geometry compiled afresh at batches 1, 3
    and 16 x (probs, logits) through ``run``, a token-input graph at T =
    16 and 32, ``make_server("resnet18")`` and a saved and loaded
    ResNet-18: at every key the first request captures and a second draw
    replays, both answers kept and each ``torch.equal`` to eager
    ``execute_packed`` on the card on its own draw (no aliasing),
    ``forward_launches`` per request and key warm-up on the counters;
    one b16 replay of each net profiled: exactly one ``crossbar_gemm``
    and one ``fb_epilogue`` kernel per stage and, of ``quantize_layout``,
    the kernels its paths launch per stage (``device_kernels``), by name
    (``KERNEL_NAMES``), the other kernels by name (standard error and the
    line), vit_tiny's dynamic stages run again alone launching the
    wrappers' kernels and nothing else (``dyn_stage_kernels``), ViT-S/16's
    tapped epilogues made again from their operands, one launch each, the
    tap ``torch.equal`` to the plain path and the rows to the call without
    a tap (``tapped_stages``), and the static stages dispatching no
    PyTorch op
    of a requant factor (``static_stage_ops``); time per batch at 1, 4
    and 16
    through ``run`` (replay) beside eager ``execute_packed``, each with
    busy time and idle share, the replay's busy time by wrapper; the
    capture seconds of every key and each profile's largest kernels
    (standard error; min/median/max per net on the line).  To run it
    alone, drive ``executable_phase`` from a script under ``build/``
    after the kernel build;
28. the compiled LM decode step's cases at ``reduced()`` that 21, 24 and
    26 do not reach (``decode_cases_phase``): sliding-window rings past
    their window, a second params tree (a key of its own), a foreign
    cache tree (copied in), a call under a mesh context (raises), each
    answer ``torch.equal`` to the eager step;
29. ``quantize_layout``, the executor's left operands
    (``quantize_phase``): ResNet-18, AlexNet at ``adc_bits=8``, VGG-16,
    vit_tiny and ViT-S/16 at batches 1, 3 and 16, and ResNet-18 b16,
    AlexNet b4
    and vit_tiny b16 at every ``WIDTHS`` row, driven eagerly
    (``record_stages``): one launch per static stage and two per dynamic
    stage (the right operand, then the left one given its amax), every
    call's (x8, amax) and requant factor (the static stages', and the
    dynamic stages' per-slice plain product) ``torch.equal`` to the plain
    version on the same card tensors, no card tensor reaching the plain
    version; ``QUANT_TIES`` near ties on both paths, among them V's
    transposed heads at 4 bits on the sliced branch; vit_tiny b16's
    dynamic-stage calls profiled (exactly ``device_kernels``) and timed
    beside their bound, plain version and replaced chain; per ResNet-18
    forward at b16,
    b3 and b1 the device kernels of all its calls (profiled: exactly
    ``device_kernels``, no memset or other kernel), the kernel's device
    time beside its bound, the plain version and the PyTorch chain it
    replaced (``old_chain`` with ``dequant_scale``, held equal too), each
    call also with the one-launch and the multi-pass path forced (the
    threshold between them, standard error), and the largest stage
    alone.

Phases run in the order 1-20, 27, 29, 28, 21, 22, 24-26, 23: phase 27
profiles before the LM phases have traced anything, and phase 23's dry-run
processes (host cores only) run in the background beside 24-26, so its
line follows 26.  The line before the last is the JSON record of the
kernels; the last is ``{"ok": true, "device": {...}}``.  Any failed check
raises before it.

``python3 chip_smoke.py --kernel-times [--src DIR] [--label NAME]`` only
times ``fb_epilogue``, ``flash_attention``, ``fused_gemm_epilogue`` and
``packed_gemm`` (``kernel_times``) for the ``repro_torch`` under ``DIR``:
run on a ``git archive`` of a parent commit and on this tree in one
call, it compares the two on one card.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
ATTN_T = (16, 64, 256)           # the attention bench's sequence lengths
GROUP_SIZES = ([256, 128, 384], [200, 56, 300, 100], [128], [0, 256, 0, 128])
TIMED_LAUNCHES = 25
# (mode name, fb_epilogue kwargs, needs residual, atol, reason).  atol 0
# means bit for bit: the kernel and the plain version round the same
# operations in the same order.
FB_CASES = [
    ("none", dict(), False, 0.0, "same roundings"),
    ("relu", dict(act="relu"), False, 0.0, "same roundings"),
    ("relu+residual", dict(act="relu"), True, 0.0, "same roundings"),
    ("post_scale", dict(post_scale=0.125), False, 0.0, "same roundings"),
    ("maxpool", dict(act="relu", pool="max", window=2, img_hw=32), False,
     0.0, "max is exact"),
    ("avgpool", dict(act="relu", pool="avg", window=4, img_hw=4), True,
     0.0, "same summation order"),
    ("gelu", dict(act="gelu"), False, 1e-6, "tanhf vs torch.tanh"),
    ("layer", dict(norm="layer"), True, 1e-5, "order of the row sums"),
    ("seqmean", dict(act="gelu", norm="layer", pool="seqmean", window=64),
     True, 1e-5, "order of the row and token sums"),
    ("softmax", dict(softmax=True), False, 1e-6, "order of the row sum"),
]


# phase 4's widths beside each mode's own: the 16-byte path (N % 4 == 0,
# the program's widths) and the scalar one; the row modes also at the
# longest row a warp holds and one past it (the block-per-row path)
FB_WIDTHS = (64, 192, 768, 10, 19, 77)
FB_ROW_WIDTHS = (1024, 1025)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(line: str) -> None:
    """A phase line, on standard output."""
    print(line, flush=True)


def detail(line: str) -> None:
    """A per-shape detail, on standard error."""
    print(line, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


def device_ms(fn, calls: int = TIMED_LAUNCHES, replays: int = 5) -> float:
    """Device time per call of ``fn``, without the host's launch gaps.

    After 3 warm-up calls on a side stream, ``calls`` calls are captured
    in one CUDA graph; the graph is replayed ``replays`` times between
    two CUDA events, and the median replay time over ``calls`` is the
    time of one call.
    """
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def forward_profile(fn, runs: int = 3, top: int | None = 8,
                    name_chars: int = 60,
                    warm: bool = True) -> tuple[float | None, list]:
    """(device-busy ms, top kernels) per call of a forward, or (None, [])
    when the profiler sees no device events.

    Busy time is the summed duration of the device's kernels and copies
    per call (profiler device events); a first short session warms the
    profiler up (``warm=False`` leaves it out, where an earlier session
    has warmed it and ``fn`` launches too much to trace twice).  The
    kernels are (ms, launches, name) per call, grouped by the first
    ``name_chars`` characters of their names, the ``top`` largest by time
    (all of them when ``top`` is None).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if warm:
        with profile(activities=acts):
            fn()
            torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = by_name.setdefault(e.name[:name_chars], [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3 / runs
            t[1] += 1
    if not by_name:
        return None, []
    kernels = sorted(((ms, n // runs, name) for name, (ms, n)
                      in by_name.items()), reverse=True)
    return sum(ms for ms, _, _ in kernels), kernels[:top]


def wall_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize,
    after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def events_ms(fn, calls: int = TIMED_LAUNCHES) -> float:
    """Time per call of ``fn`` between two CUDA events around ``calls``
    calls, after 3 warm-ups: for functions that synchronize with the host
    and cannot be captured in a graph (launch gaps included)."""
    import torch
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def sass_opcodes(build, name: str) -> dict | None:
    """Counts of the tensor-core (IGMMA int8 warpgroup, HMMA / HGMMA
    float), dot-product (IDP.4A) and popcount (POPC) instructions in a
    kernel library's SASS, from ``cuobjdump -sass`` beside ``nvcc``;
    None where there is none."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=120).stdout
    return {op: len(re.findall(pattern, out)) for op, pattern in (
        ("IGMMA", r"\bIGMMA\."), ("HMMA", r"\bHMMA\."),
        ("HGMMA", r"\bHGMMA\."), ("IDP4A", r"\bIDP\.4A"),
        ("POPC", r"\bPOPC\b"))}


def gemm_bound(M: int, N: int, K: int, sliced: bool) -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms) of one crossbar GEMM.

    Bytes: each int8 operand read once, the int32 output written once.
    Operations: 2*M*N*K int8 ops; the sliced branch's per-plane counts
    are 64 {0,1} products of the same size, counted as int8 ops.
    """
    nbytes = M * K + K * N + 4 * M * N
    ops = 2 * M * N * K * (64 if sliced else 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3


def int_mm_ms(x, w) -> tuple[float, float]:
    """``torch._int_mm``'s device time on (M, K) x (K, N) int8, padded to
    its shape rules (M > 16, K and N multiples of 8): with the weight
    row-major (K, N), then K-major (the transpose of an (N, K) contiguous
    tensor: the layout cuBLASLt's int8 kernels take)."""
    import torch
    F = torch.nn.functional
    (M, K), N = x.shape, w.shape[1]
    xl = F.pad(x, (0, -K % 8, 0, max(0, 17 - M))).contiguous()
    wl = F.pad(w, (0, -N % 8, 0, -K % 8)).contiguous()
    wk = wl.t().contiguous()
    return (device_ms(lambda: torch._int_mm(xl, wl)),
            device_ms(lambda: torch._int_mm(xl, wk.t())))


def fb_bound(M: int, N: int, out_rows: int, has_res: bool) -> float:
    """Bytes-bound ms of one epilogue: the int32 input (and the residual)
    and the bias read once, the f32 output written once."""
    nbytes = 4 * M * N * (2 if has_res else 1) + 4 * N + 4 * out_rows * N
    return nbytes / HBM_BYTES_PER_S * 1e3


def stage_shapes(model, batch: int) -> list[dict]:
    """Per-stage (M, K, N, rows, epilogue kwargs) of a batch's forward;
    K is the stage's ``layout_k`` (the logical K on the exact branch) and
    ``w8`` the planes' first K rows, which ``wt`` lays out."""
    from repro_torch.program.pack import layout_k
    out = []
    adc = model.program.cfg.adc_bits
    for (gemm, posts), st in zip(model.program.stages(), model.packed.stages):
        M = batch * gemm.out_hw ** 2 if gemm.is_conv else batch
        kw, has_res, n_out = {}, False, M
        for op in posts:
            if op.kind == "relu":
                kw["act"] = "relu"
            elif op.kind == "residual":
                has_res = True
            elif op.kind in ("maxpool", "avgpool"):
                kw.update(pool="max" if op.kind == "maxpool" else "avg",
                          window=op.window, img_hw=op.in_hw)
                n_out = batch * op.out_hw ** 2
            elif op.kind == "softmax":
                kw["softmax"] = True
        K = layout_k(gemm, adc)
        out.append(dict(name=gemm.name, M=M, K=K, N=st.w8.shape[1],
                        rows=gemm.tile_rows, fb=kw, res=has_res,
                        out_rows=n_out, w8=st.w8[:K], wt=st.wt))
    return out


def attn_bound(B: int, Sq: int, Sk: int, H: int, hd: int,
               causal: bool = False,
               dtype: str = "float32") -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms) of one attention: q, k, v
    read once and the output written once; 4*hd operations per (query,
    key) pair it sees (Sq*Sk, or the lower triangle when causal) per
    (b, h), at the float32 peak outside the tensor cores or the bf16
    tensor-core peak."""
    size, peak = (4, F32_OPS_PER_S) if dtype == "float32" else \
        (2, BF16_OPS_PER_S)
    nbytes = size * B * H * hd * (2 * Sq + 2 * Sk)
    pairs = sum(min(Sk, i + 1) for i in range(Sq)) if causal else Sq * Sk
    ops = 4 * B * H * pairs * hd
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3


# flash_attention's timed shapes beside SDPA (phase 15 and
# --kernel-times): (B, S, H, hd), causal, dtype
FLASH_TIMED = [((1, 512, 4, 64), False, "float32"),
               ((1, 512, 4, 64), True, "float32"),
               ((16, 64, 3, 64), False, "float32"),
               ((1, 512, 4, 64), False, "bfloat16"),
               ((1, 512, 4, 64), True, "bfloat16")]


def flash_times(dev, gen, attn_shapes=ATTN_T) -> dict:
    """Device times of ``flash_attention`` beside SDPA: the attention
    path's (1, T, 4, 16) summed over ``attn_shapes`` (non-causal,
    float32, with the plain version), and each ``FLASH_TIMED`` shape."""
    import torch
    from repro_torch.kernels import flash_attention, flash_attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    path = dict(ms=0.0, plain=0.0, lib=0.0, by={"bytes": 0.0,
                                                  "operations": 0.0})
    for T in attn_shapes:
        q, k, v = (torch.randn(1, T, 4, 16, generator=gen, device=dev)
                   for _ in range(3))
        f_ms = device_ms(lambda: flash_attention(q, k, v, causal=False))
        f_plain = device_ms(lambda: flash_attention_ref(q, k, v,
                                                        causal=False))
        f_lib = device_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2)))
        b_ms, o_ms = attn_bound(1, T, T, 4, 16)
        path["by"]["bytes" if b_ms >= o_ms else "operations"] += max(b_ms,
                                                                     o_ms)
        path["ms"] += f_ms
        path["plain"] += f_plain
        path["lib"] += f_lib
        detail(f"time flash_attention (1,{T},4,16): {f_ms:.4f} ms (bound "
               f"{max(b_ms, o_ms):.5f}, plain {f_plain:.4f}, sdpa "
               f"{f_lib:.4f})")
    shapes = []
    for shape, causal, dt in FLASH_TIMED:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        f_ms = device_ms(lambda: flash_attention(q, k, v, causal=causal))
        f_lib = device_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), is_causal=causal))
        b_ms, o_ms = attn_bound(shape[0], shape[1], shape[1], shape[2],
                                shape[3], causal, dt)
        shapes.append(dict(shape=list(shape), causal=causal, dtype=dt,
                           ms=f_ms, sdpa_ms=f_lib, bound_ms=max(b_ms, o_ms)))
        detail(f"time flash_attention {shape} causal={causal} {dt}: "
               f"{f_ms:.4f} ms (bound {max(b_ms, o_ms):.5f}, sdpa "
               f"{f_lib:.4f})")
    return dict(path=path, shapes=shapes)


def fb_stage_times(shapes, dev, gen) -> dict:
    """``fb_epilogue``'s device time at each stage of a forward (the
    shapes of ``stage_shapes``), beside its byte bound and its plain
    version, summed; the five stages furthest from their bound go to
    standard error."""
    import torch
    from repro_torch.kernels import fb_epilogue, fb_epilogue_ref
    f = dict(ms=0.0, plain=0.0, bound=0.0, stages=[])
    for s in shapes:
        M, N = s["M"], s["N"]
        y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=gen,
                          device=dev, dtype=torch.int32)
        scale = torch.full((1, 1), 3.1e-6, device=dev)
        bias = torch.randn(N, generator=gen, device=dev)
        res = torch.randn(M, N, generator=gen, device=dev) if s["res"] \
            else None
        f_ms = device_ms(lambda: fb_epilogue(y, scale, bias, res, **s["fb"]))
        f_plain = device_ms(lambda: fb_epilogue_ref(y, scale, bias, res,
                                                    **s["fb"]))
        f_bound = fb_bound(M, N, s["out_rows"], s["res"])
        f["ms"] += f_ms
        f["plain"] += f_plain
        f["bound"] += f_bound
        f["stages"].append((f_ms - f_bound, s["name"], f_ms, f_bound))
        detail(f"time fb_epilogue {s['name']}: M={M} N={N} {s['fb']} "
               f"res={s['res']} {f_ms:.4f} ms (bound {f_bound:.5f}, plain "
               f"{f_plain:.4f})")
    for gap, name, ms, bnd in sorted(f["stages"], reverse=True)[:5]:
        detail(f"top offender fb_epilogue {name}: {ms:.4f} ms, bound "
               f"{bnd:.5f}, gap {gap:.4f} ms")
    return f


def dyn_fb_times(dev, gen, S: int = 48, T: int = 64) -> dict:
    """``fb_epilogue``'s batched launches at vit_tiny's dynamic stages
    (b16: 48 slices of 64x64), as the executor calls them (no bias): the
    scores' softmax + post_scale and the context's dequant stored with
    its 3 heads merged, summed as one (scores, context) pair.  A tree
    whose wrapper takes no ``heads`` (``--kernel-times --src`` of an
    older one) gets its executor's form: a zero bias, no merge."""
    import inspect
    import torch
    from repro_torch.kernels import fb_epilogue, fb_epilogue_ref
    y32 = torch.randint(-2 ** 16, 2 ** 16, (S, T, T), generator=gen,
                        device=dev, dtype=torch.int32)
    sc = torch.rand(S, 1, 1, generator=gen, device=dev) * 1e-4
    sm = dict(softmax=True, post_scale=0.125)
    merged = "heads" in inspect.signature(fb_epilogue).parameters
    bias = None if merged else torch.zeros(T, device=dev)
    ctx = dict(heads=3) if merged else {}
    return dict(
        ms=device_ms(lambda: fb_epilogue(y32, sc, bias, **sm))
        + device_ms(lambda: fb_epilogue(y32, sc, bias, **ctx)),
        plain=device_ms(lambda: fb_epilogue_ref(y32, sc, bias, **sm))
        + device_ms(lambda: fb_epilogue_ref(y32, sc, bias, **ctx)),
        bound=2 * fb_bound(S * T, T, S * T, False))


def float_gemm_bound(M: int, K: int, N: int, w_elems: int,
                     dtype: str = "float32",
                     bias: int = 0) -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms) of a float GEMM: x and w in
    ``dtype`` and ``bias`` float32 values read once, the output written
    once; 2*M*K*N operations at the float32 peak outside the tensor
    cores (float32) or the bf16 tensor-core peak (bfloat16)."""
    size, peak = (4, F32_OPS_PER_S) if dtype == "float32" else \
        (2, BF16_OPS_PER_S)
    nbytes = size * (M * K + w_elems + M * N) + 4 * bias
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * M * K * N / peak * 1e3


# fused_gemm_epilogue's and packed_gemm's timed cases (phase 15 and
# --kernel-times), each in GEMM_DTYPES: the kernel bench's shapes
# (benchmarks/kernels_bench.py) and one larger shape each
FUSED_TIMED = [((256, 512, 256), "silu"), ((256, 512, 256), "relu"),
               ((2048, 2048, 2048), "silu")]
PACKED_TIMED = [(GROUP_SIZES[1], 128, 256),
                ([700, 300, 612, 484, 388, 516, 596, 500], 1024, 1024)]
GEMM_DTYPES = ("float32", "bfloat16")


def _yardstick(fn) -> float | None:
    """A library call's device time (``device_ms``); where the call cannot
    be captured in a CUDA graph (``torch._grouped_mm`` in float32 copies
    to the host), its time by CUDA events around 25 calls, launch gaps
    included (``events_ms``); None where this torch refuses the call.
    The port never calls it."""
    import torch
    try:
        fn()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        detail(f"  yardstick refused: {str(e).splitlines()[0][:120]}")
        return None
    try:
        return device_ms(fn)
    except RuntimeError as e:
        torch.cuda.synchronize()
        detail(f"  yardstick not capturable ({str(e).splitlines()[0][:80]}"
               "): timed by events, launch gaps included")
        return events_ms(fn)


def float_gemm_times(dev, gen) -> dict:
    """Device times of ``fused_gemm_epilogue`` (x (M, K), w (K, N) * 0.05,
    a float32 bias) at ``FUSED_TIMED`` and of ``packed_gemm`` (the kernel
    on ``pad_groups``' rows, block_m 128) at ``PACKED_TIMED``, each in
    float32 and bfloat16, beside their bounds, their plain versions and
    the library yardsticks: ``torch.addmm`` (the bias only; for ReLU
    also ``torch._addmm_activation``, the same function), a per-group
    ``torch.matmul`` loop, and ``torch._grouped_mm`` where this torch
    takes the case.  Uses only what the port had before its Hopper
    redesign, so it times another checkout's kernels too."""
    import numpy as np
    import torch
    from repro_torch.kernels import (fused_gemm_epilogue,
                                     fused_gemm_epilogue_ref,
                                     packed_gemm_tiles_ref, pad_groups,
                                     tile_group_map)
    packed_module = importlib.import_module("repro_torch.kernels.packed_gemm")
    fused, packed = [], []
    for (M, K, N), act in FUSED_TIMED:
        for dt in GEMM_DTYPES:
            dtype = getattr(torch, dt)
            x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
            w = (torch.randn(K, N, generator=gen, device=dev) * .05).to(dtype)
            b = torch.randn(N, generator=gen, device=dev)
            bd = b.to(dtype)
            ms = device_ms(lambda: fused_gemm_epilogue(x, w, b, act=act))
            plain = device_ms(lambda: fused_gemm_epilogue_ref(x, w, b,
                                                              act=act))
            lib = {"addmm": _yardstick(lambda: torch.addmm(bd, x, w))}
            if act == "relu":
                lib["_addmm_activation"] = _yardstick(
                    lambda: torch._addmm_activation(bd, x, w))
            b_ms, o_ms = float_gemm_bound(M, K, N, K * N, dt, bias=N)
            row = dict(shape=[M, K, N], act=act, dtype=dt, ms=ms,
                       plain_ms=plain, library_ms=lib,
                       bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations")
            fused.append(row)
            detail(f"time fused_gemm_epilogue {M}x{K}x{N} {act} {dt}: "
                   f"{ms:.4f} ms (bound {row['bound_ms']:.5f} by "
                   f"{row['bound_by']}, plain {plain:.4f}, library {lib})")
    for sizes, K, N in PACKED_TIMED:
        G = len(sizes)
        for dt in GEMM_DTYPES:
            dtype = getattr(torch, dt)
            wg = (torch.randn(G, K, N, generator=gen, device=dev) * .1
                  ).to(dtype)
            xg = torch.randn(sum(sizes), K, generator=gen, device=dev
                             ).to(dtype)
            xp, padded, _, _ = pad_groups(xg, sizes, 128)
            tiles = tile_group_map(padded, 128, xp.shape[0] // 128)
            tiles_dev = tiles.to(dev)
            ms = device_ms(lambda: packed_module._launch(xp, wg, tiles_dev,
                                                         128))
            plain = events_ms(lambda: packed_gemm_tiles_ref(xp, wg, tiles,
                                                            128))
            ends = np.cumsum(padded.numpy())
            starts = np.concatenate([[0], ends[:-1]])
            lib = {"matmul loop": _yardstick(
                lambda: [xp[a:e] @ wg[i] for i, (a, e)
                         in enumerate(zip(starts, ends))])}
            grouped_mm = getattr(torch, "_grouped_mm", None)
            offs = torch.from_numpy(ends.astype(np.int32)).to(dev)
            lib["_grouped_mm"] = None if grouped_mm is None else _yardstick(
                lambda: grouped_mm(xp, wg, offs=offs))
            b_ms, o_ms = float_gemm_bound(sum(sizes), K, N, G * K * N, dt)
            row = dict(groups=G, rows=sum(sizes), K=K, N=N, dtype=dt, ms=ms,
                       plain_ms=plain, library_ms=lib,
                       bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations")
            packed.append(row)
            detail(f"time packed_gemm {G} groups {sum(sizes)} rows K {K} "
                   f"N {N} {dt}: {ms:.4f} ms (bound {row['bound_ms']:.5f} "
                   f"by {row['bound_by']}, plain {plain:.4f}, library "
                   f"{lib})")
    return dict(fused=fused, packed=packed)


EDGE_M = (1, 4, 16)
EDGE_K = (27, 101, 988, 1458, 4860)
EDGE_N = (10, 19, 77)
EDGE_ROWS = (247, 486, 494, 511, 512)
# the exact static stages of the benchmark's b1024 cells: (stage, M, K, N),
# K the logical one (vit_s16: 1024 x 196 tokens; resnet18: 32x32 images);
# every one takes the wide tiles
CELL_SHAPES = (("vit_s16 patch", 200704, 768, 384),
               ("vit_s16 qkv", 200704, 384, 1152),
               ("vit_s16 proj", 200704, 384, 384),
               ("vit_s16 fc1", 200704, 384, 1536),
               ("vit_s16 fc2", 200704, 1536, 384),
               ("resnet18 s0 conv", 1048576, 576, 64),
               ("resnet18 s1 conv", 262144, 1152, 128),
               ("resnet18 s2 conv", 65536, 2304, 256),
               ("resnet18 s3 conv", 16384, 4608, 512))
# 2-D calls that fill the card, each width of the wide tiles (M, K, N, bn):
# ragged M, N and K, vit_s16's fc2 and head widths, resnet18's s3 conv
WIDE_CASES = ((16891, 300, 10, 64), (16891, 1152, 128, 128),
              (16896, 1536, 384, 192), (17000, 384, 1000, 256),
              (16384, 4608, 512, 256))
WIDE_TIMED = "vit_s16 fc1"       # the CELL_SHAPES stage phase 7 times


def cell_operands(gen, M: int, K: int, N: int) -> tuple:
    """Seeded operands of an exact 2-D call, (x, w, xk, wt): x (M, K) and
    w (K, N), and the main path's form of them, x in the kernel layout
    and the mounted ``wt``."""
    import torch
    from repro_torch.kernels import kernel_layout, mount_weight
    x, w = (torch.randint(-128, 128, shape, generator=gen, device=gen.device,
                          dtype=torch.int8) for shape in ((M, K), (K, N)))
    return (x, w, kernel_layout(x, K, rows=511, exact=True).contiguous(),
            mount_weight(w, rows=511, exact=True))


def _gemm_err(y, ref) -> int:
    return (y.long() - ref.long()).abs().max().item() if y.numel() else 0


def _split_on_and_off(dev, gen, exact: bool, M: int, K: int, N: int,
                      rows: int, adc: int) -> int:
    """One shape through the kernel with the K split it picks (> 1) and
    with none, both equal to the plain version; returns the split."""
    import torch
    from repro_torch.kernels import (crossbar_gemm_exact_ref,
                                     crossbar_gemm_ref, kernel_layout,
                                     mount_weight)
    module = importlib.import_module("repro_torch.kernels.crossbar_gemm")
    x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    x[: max(1, M // 4)] = -1
    w[:, : max(1, N // 4)] = -1
    kw = dict(rows=rows, adc_bits=adc, exact=exact)
    wt, xk = mount_weight(w, **kw), kernel_layout(x, K, **kw).contiguous()
    r = min(rows, K)
    split = module.splits(1, M, N, wt.shape[-1], exact=exact,
                          rows32=-(-r // 32) * 32)
    check(split > 1, f"no K split at M={M} K={K} N={N} exact={exact}")
    ref = crossbar_gemm_exact_ref(x, w) if exact else \
        crossbar_gemm_ref(x, w, adc_bits=adc, rows=rows)
    for forced in (0, 1):            # 0: the kernel's own split
        force = (dict(plan=module.ExactPlan(64, 64, 1) if forced else None)
                 if exact else dict(split=forced))
        y = module._launch(xk, wt, N, exact=exact, rows=r, adc_bits=adc,
                           **force)
        check(torch.equal(y, ref), f"crossbar_gemm exact={exact} M={M} "
              f"K={K} N={N} split={'auto' if forced == 0 else 1} differs")
    return split


def wide_phase(gen) -> dict:
    """Phase 2's wide tiles: ``WIDE_CASES`` in the main path's form, each
    under the wide plan of its width and equal to the plain version, one
    ``crossbar_gemm`` launch a call.  Returns the cases, launches and max
    error."""
    from repro_torch.kernels import crossbar_gemm, crossbar_gemm_exact_ref
    module = importlib.import_module("repro_torch.kernels.crossbar_gemm")
    worst, before = 0, launches_of(crossbar_gemm)
    for M, K, N, bn in WIDE_CASES:
        x, w, xk, wt = cell_operands(gen, M, K, N)
        plan = module.exact_plan(1, M, N, xk.shape[1])
        check(plan == module.ExactPlan(128, bn, 1), f"crossbar_gemm M={M} "
              f"K={K} N={N} plans {plan}, not the {bn}-wide tiles")
        err = _gemm_err(crossbar_gemm(xk, rows=511, wt=wt, K=K),
                        crossbar_gemm_exact_ref(x, w))
        worst = max(worst, err)
        check(err == 0, f"crossbar_gemm wide tiles differ at M={M} K={K} "
              f"N={N}")
    launches = launches_of(crossbar_gemm) - before
    check(launches == len(WIDE_CASES), f"{launches} crossbar_gemm launches "
          f"for {len(WIDE_CASES)} wide calls")
    return dict(cases=len(WIDE_CASES), launches=launches, err=worst)


def wide_times(gen) -> dict:
    """Phase 7's wide tiles at a b1024 cell's shape (``WIDE_TIMED``): the
    kernel's device time, its plain version's, its bound and
    ``torch._int_mm`` with the weight K-major."""
    import torch
    from repro_torch.kernels import crossbar_gemm, crossbar_gemm_exact_ref
    stage, M, K, N = next(c for c in CELL_SHAPES if c[0] == WIDE_TIMED)
    x, w, xk, wt = cell_operands(gen, M, K, N)

    def run():
        return crossbar_gemm(xk, rows=511, wt=wt, K=K)
    check(torch.equal(run(), crossbar_gemm_exact_ref(x, w)),
          f"crossbar_gemm wide tiles differ at {stage} b1024")
    b_ms, o_ms = gemm_bound(M, N, K, sliced=False)
    return dict(stage=stage, M=M, K=K, N=N, ms=device_ms(run),
                plain=device_ms(lambda: crossbar_gemm_exact_ref(x, w),
                                calls=5),
                bound=max(b_ms, o_ms),
                by="bytes" if b_ms >= o_ms else "operations",
                lib=int_mm_ms(x, w)[1])


def gemm_exact_phase(dev, gen, shapes) -> tuple[int, int, int]:
    """Phase 2: the exact branch against its plain version: ResNet-18's
    stages in the main path's form (x laid out by ``kernel_layout``, the
    packed ``wt``), ragged shapes through a plain (K, N) weight, the edge
    shapes, all -128 (the largest |y|), and the K split on and off; all
    these take the 64 x 64 tiles (``wide_phase`` holds the wide ones).
    Returns (max error, cases, the split of the split-on case)."""
    import torch
    from repro_torch.kernels import (crossbar_gemm, crossbar_gemm_exact_ref,
                                     kernel_layout)

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    worst, n = 0, 0
    for st in shapes:
        x = rand_i8(st["M"], st["K"])
        xk = kernel_layout(x, st["K"], rows=st["rows"])
        y = crossbar_gemm(xk, st["w8"], rows=st["rows"], wt=st["wt"])
        err = _gemm_err(y, crossbar_gemm_exact_ref(x, st["w8"]))
        worst, n = max(worst, err), n + 1
        check(err == 0, f"crossbar_gemm exact differs at stage {st['name']}")
    cases = [(1, 27, 10, 27), (37, 101, 19, 27), (1000, 494, 77, 494),
             (129, 1000, 65, 494), (3, 5, 3, 494)]
    cases += [(M, K, N, 511) for M in EDGE_M for K in EDGE_K for N in EDGE_N]
    for M, K, N, rows in cases:
        x, w = rand_i8(M, K), rand_i8(K, N)
        err = _gemm_err(crossbar_gemm(x, w, rows=rows),
                        crossbar_gemm_exact_ref(x, w))
        worst, n = max(worst, err), n + 1
        check(err == 0, f"crossbar_gemm exact differs at M={M} K={K} N={N}")
    x = torch.full((16, 4860), -128, dtype=torch.int8, device=dev)
    w = torch.full((4860, 77), -128, dtype=torch.int8, device=dev)
    y = crossbar_gemm(x, w, rows=511)
    check(bool((y == 4860 * 2 ** 14).all()), "crossbar_gemm exact on all "
          "-128 operands is not K * 2^14")
    split = _split_on_and_off(dev, gen, True, 256, 4860, 512, 486, 9)
    return worst, n + 2, split


def _sliced_cases(dev, gen, cases) -> tuple[int, int]:
    """Each (adc, rows, M, K, N) of ``cases`` through the sliced branch
    against its plain version, a quarter of the rows and columns all
    ones (their counts reach the chunk height); a clip must fire exactly
    where ``clip_possible`` says.  Returns (max error, cases where a clip
    fired)."""
    import torch
    from repro_torch.kernels import (clip_possible, crossbar_gemm,
                                     crossbar_gemm_exact_ref,
                                     crossbar_gemm_ref)
    worst = clipped = 0
    for adc, rows, M, K, N in cases:
        x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        x[: max(1, M // 4)] = -1             # all bits set: counts = rows
        w[:, : max(1, N // 4)] = -1
        y = crossbar_gemm(x, w, adc_bits=adc, rows=rows, exact=False)
        ref = crossbar_gemm_ref(x, w, adc_bits=adc, rows=rows)
        err = _gemm_err(y, ref)
        worst = max(worst, err)
        check(err == 0, f"crossbar_gemm sliced differs at "
              f"adc={adc} rows={rows} M={M} K={K} N={N}")
        fired = not torch.equal(ref, crossbar_gemm_exact_ref(x, w))
        check(fired == clip_possible(rows, adc), f"ADC clips at adc={adc} "
              f"rows={rows} M={M}: fired {fired}")
        clipped += int(fired)
    return worst, clipped


def _all_minus_one(dev, adc: int, rows: int) -> None:
    """All -1 operands (every bit set: each count equals the chunk height
    and clips wherever a clip can fire) through the sliced branch, equal to
    the plain version."""
    import torch
    from repro_torch.kernels import (clip_possible, crossbar_gemm,
                                     crossbar_gemm_exact_ref,
                                     crossbar_gemm_ref)
    x = torch.full((16, 4860), -1, dtype=torch.int8, device=dev)
    w = torch.full((4860, 77), -1, dtype=torch.int8, device=dev)
    y = crossbar_gemm(x, w, adc_bits=adc, rows=rows, exact=False)
    ref = crossbar_gemm_ref(x, w, adc_bits=adc, rows=rows)
    check(torch.equal(y, ref), f"crossbar_gemm sliced differs on all -1 "
          f"operands at adc={adc} rows={rows}")
    check(torch.equal(ref, crossbar_gemm_exact_ref(x, w))
          != clip_possible(rows, adc), f"all -1 operands at adc={adc} "
          f"rows={rows}: clips not where clip_possible says")


def gemm_sliced_phase(dev, gen) -> tuple[int, int, int, int]:
    """Phase 3: the sliced branch against its plain version on inputs where
    clips fire (a quarter of the rows and columns all ones), every chunk
    height of the program and the smoke run at M = 1, 4, 16, all -1 (every
    count equals the chunk height), and the chunk split on and off.
    Returns (max error, cases, cases where a clip fired, the split)."""
    cases = [(8, 494, 2048, 988, 64), (8, 494, 1024, 1976, 384),
             (9, 512, 512, 1536, 96), (9, 512, 33, 700, 17),
             (8, 486, 64, 4446, 1024)]
    cases += [(8, rows, M, 1458, 77) for rows in EDGE_ROWS for M in EDGE_M]
    worst, clipped = _sliced_cases(dev, gen, cases)
    _all_minus_one(dev, 8, 494)
    split = _split_on_and_off(dev, gen, False, 4, 4374, 1024, 486, 8)
    return worst, len(cases) + 2, clipped + 1, split


def batched_phase(dev, gen) -> tuple[int, int, float]:
    """Phase 8: one batched launch at vit_tiny's dynamic shapes (batch 16
    x 3 heads, 64 tokens, hd 64), held against the plain versions on the
    same inputs and against the per-slice 2-D calls; also in the forms
    the executor's dynamic stages call: ``crossbar_gemm`` on ``wt`` and K
    alone, ``fb_epilogue`` with no bias and the context's heads merged on
    store.  Returns the kernel-against-plain errors: exact GEMM, sliced
    GEMM, epilogue."""
    import torch
    from repro_torch.kernels import (crossbar_gemm, crossbar_gemm_ref,
                                     fb_epilogue, fb_epilogue_ref,
                                     kernel_layout, mount_weight)
    S, T, hd = 16 * 3, 64, 64
    x = torch.randint(-128, 128, (S, T, hd), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (S, hd, T), generator=gen, device=dev,
                      dtype=torch.int8)
    x[:, :8] = -1                        # all bits set: counts reach rows
    w[:, :, :8] = -1
    gemm_err = {}
    for adc in (9, 5):                   # 64 rows: exact; then sliced
        before = launches_of(crossbar_gemm)
        y = crossbar_gemm(x, w, adc_bits=adc, rows=hd)
        check(launches_of(crossbar_gemm) - before == 1,
              "batched crossbar_gemm is not one launch")
        ref = crossbar_gemm_ref(x, w, adc_bits=adc, rows=hd)
        gemm_err[adc] = (y.long() - ref.long()).abs().max().item()
        check(torch.equal(y, ref), f"batched crossbar_gemm (adc {adc}) "
              f"differs from the plain version by {gemm_err[adc]}")
        per = torch.stack([crossbar_gemm(x[i], w[i], adc_bits=adc, rows=hd)
                           for i in range(S)])
        check(torch.equal(y, per), f"batched crossbar_gemm (adc {adc}) "
              "differs from the per-slice calls")
        xk = kernel_layout(x, hd, rows=hd, adc_bits=adc).contiguous()
        wt = mount_weight(w, rows=hd, adc_bits=adc)
        check(torch.equal(crossbar_gemm(xk, adc_bits=adc, rows=hd, wt=wt,
                                        K=hd), ref),
              f"batched crossbar_gemm on wt and K alone (adc {adc}) "
              "differs from the plain version")
    # the slice axis at ragged M, K and N, through a mounted weight
    xr = torch.randint(-128, 128, (5, 16, 1001), generator=gen, device=dev,
                       dtype=torch.int8)
    wr = torch.randint(-128, 128, (5, 1001, 19), generator=gen, device=dev,
                       dtype=torch.int8)
    xr[:, :3] = -1
    wr[:, :, :4] = -1
    for adc, rows in ((9, 511), (8, 247), (8, 494)):
        wt = mount_weight(wr, rows=rows, adc_bits=adc, exact=False)
        y = crossbar_gemm(xr, wr, adc_bits=adc, rows=rows, exact=False,
                          wt=wt)
        check(torch.equal(y, crossbar_gemm_ref(xr, wr, adc_bits=adc,
                                               rows=rows)),
              f"batched ragged crossbar_gemm (adc {adc}, rows {rows}) "
              "differs from the plain version")
    y32 = torch.randint(-2 ** 16, 2 ** 16, (S, T, T), generator=gen,
                        device=dev, dtype=torch.int32)
    scale = torch.rand(S, 1, 1, generator=gen, device=dev) * 1e-4
    bias = torch.zeros(T, device=dev)
    fb_err = 0.0
    # the tolerances of FB_CASES: softmax to the order of the row sum,
    # the FMA dequant with the same roundings
    for kw, atol in ((dict(softmax=True, post_scale=0.125), 1e-6),
                     (dict(), 0.0)):
        before = launches_of(fb_epilogue)
        out = fb_epilogue(y32, scale, bias, **kw)
        check(launches_of(fb_epilogue) - before == 1,
              "batched fb_epilogue is not one launch")
        err = (out - fb_epilogue_ref(y32, scale, bias, **kw)).abs().max()
        fb_err = max(fb_err, err.item())
        check(err.item() <= atol, f"batched fb_epilogue {kw}: max "
              f"|kernel - plain| {err.item()} > {atol}")
        per = torch.stack([fb_epilogue(y32[i], scale[i], bias, **kw)
                           for i in range(S)])
        per_err = (out - per).abs().max().item()
        check(per_err <= atol, f"batched fb_epilogue {kw}: max |batched - "
              f"per-slice| {per_err} > {atol}")
        # the dynamic stages' form: no bias (fma(y, s, +0) is y * s), and
        # the context (no softmax) stored with its 3 heads merged
        heads = 0 if kw else 3
        got = fb_epilogue(y32, scale, None, heads=heads, **kw)
        want = out.reshape(S // 3, 3, T, T).transpose(1, 2).reshape(
            S // 3, T, 3 * T) if heads else out
        check(torch.equal(got, want), f"batched fb_epilogue {kw} with no "
              f"bias, heads {heads}: differs from the zero-bias call")
        err = (got - fb_epilogue_ref(y32, scale, None, heads=heads, **kw)
               ).abs().max().item()
        check(err <= atol, f"batched fb_epilogue {kw} with no bias, heads "
              f"{heads}: max |kernel - plain| {err} > {atol}")
    return gemm_err[9], gemm_err[5], fb_err


def fb_case_shape(kw: dict) -> tuple[int, int]:
    """(M, N) of a mode's own phase-4 case."""
    if kw.get("pool") in ("max", "avg"):
        return 16 * kw["img_hw"] ** 2, 512 if kw["pool"] == "avg" else 64
    if kw.get("softmax"):
        return 16, 10
    return 16 * 256, 192 if kw.get("norm") else 64


def fb_phase(dev, gen) -> tuple[float, list, int]:
    """Phase 4: fb_epilogue in every mode against its plain version, to
    the tolerances of ``FB_CASES``, at each mode's own (M, N) and at the
    widths of ``FB_WIDTHS`` (and ``FB_ROW_WIDTHS`` for the row modes).
    Returns (max error, per-mode report, cases)."""
    import torch
    from repro_torch.kernels import fb_epilogue, fb_epilogue_ref
    worst, parts, n = 0.0, [], 0
    for mode, kw, with_res, atol, why in FB_CASES:
        M, N0 = fb_case_shape(kw)
        rows_mode = bool(kw.get("norm") or kw.get("softmax")
                         or kw.get("pool") == "seqmean")
        widths = [N0] + [N for N in FB_WIDTHS + (FB_ROW_WIDTHS if rows_mode
                                                  else ()) if N != N0]
        mode_err = 0.0
        for N in widths:
            y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=gen,
                              device=dev, dtype=torch.int32)
            scale = torch.full((1, 1), 3.1e-6, device=dev)
            bias = torch.randn(N, generator=gen, device=dev)
            res = torch.randn(M, N, generator=gen, device=dev) if with_res \
                else None
            kwn = dict(kw)
            if kw.get("norm"):
                kwn.update(gamma=torch.randn(N, generator=gen, device=dev),
                           beta=torch.randn(N, generator=gen, device=dev))
            out = fb_epilogue(y, scale, bias, res, **kwn)
            ref = fb_epilogue_ref(y, scale, bias, res, **kwn)
            err = (out - ref).abs().max().item()
            check(out.shape == ref.shape and err <= atol,
                  f"fb_epilogue {mode} M={M} N={N}: max |kernel - plain| "
                  f"{err} > {atol} ({why})")
            if atol == 0.0:
                check(torch.equal(out, ref), f"fb_epilogue {mode} M={M} "
                      f"N={N} is not equal to the plain version")
            mode_err = max(mode_err, err)
            n += 1
        worst = max(worst, mode_err)
        parts.append(f"{mode} {mode_err:.2e}")
    return worst, parts, n


FLASH_CASES = [
    # (B, S, H, hd), causal, window, dtype name, tolerance
    ((1, 128, 1, 64), True, 0, "float32", 1e-4),
    ((1, 128, 1, 64), False, 0, "float32", 1e-4),
    ((2, 256, 4, 64), True, 0, "float32", 1e-4),
    ((2, 256, 4, 64), False, 0, "float32", 1e-4),
    ((1, 512, 2, 64), True, 128, "float32", 1e-4),
    ((16, 64, 3, 64), False, 0, "float32", 1e-4),          # vit_tiny
    ((1, 16, 4, 16), False, 0, "float32", 1e-4),           # attention path
    ((1, 64, 4, 16), False, 0, "float32", 1e-4),
    ((1, 256, 4, 16), False, 0, "float32", 1e-4),
    ((1, 256, 2, 64), True, 0, "bfloat16", 2e-2),
    # every head-dim instantiation (16, 32, 64, 128)
    ((1, 128, 2, 16), True, 0, "float32", 1e-4),
    ((2, 128, 2, 32), False, 0, "float32", 1e-4),
    ((1, 256, 2, 128), True, 0, "float32", 1e-4),
    ((1, 256, 2, 128), False, 0, "float32", 1e-4),
    ((1, 256, 2, 16), False, 0, "bfloat16", 2e-2),
    ((1, 128, 2, 32), True, 0, "bfloat16", 2e-2),
    ((1, 256, 2, 128), False, 0, "bfloat16", 2e-2),
    # ragged: a last key tile of 32 (split 2), head dims below the
    # instantiation, rows that are not 16-byte aligned (synchronous loads)
    ((1, 96, 2, 64), False, 0, "float32", 1e-4),
    ((1, 64, 2, 20), False, 0, "float32", 1e-4),
    ((1, 64, 2, 18), True, 0, "float32", 1e-4),
    ((1, 128, 1, 20), True, 0, "bfloat16", 2e-2),
    # both sides of the key-split threshold: 32 blocks (split 8), 512
    # blocks (no split); bf16 at the kernel bench's shape
    ((1, 512, 4, 64), False, 0, "float32", 1e-4),
    ((1, 512, 4, 64), True, 0, "float32", 1e-4),
    ((8, 512, 8, 64), False, 0, "float32", 1e-4),
    ((1, 512, 4, 64), False, 0, "bfloat16", 2e-2),
    ((1, 512, 4, 64), True, 0, "bfloat16", 2e-2),
]


def flash_phase(dev, gen) -> tuple[float, str]:
    """Phase 9: flash_attention's kernel against its plain version, the
    key split forced on and off, run to run, and against the split's
    plain version.  Returns (max float32 error, report)."""
    import torch
    from repro_torch.kernels import flash_attention, flash_attention_ref, ops
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    worst = 0.0
    splits = {}

    def close(got, ref, tol, what):
        d = (got.float() - ref.float()).abs()
        check(bool((d <= tol + tol * ref.float().abs()).all()),
              f"{what}: max |kernel - plain| {d.max().item()} beyond {tol} "
              f"+ {tol}|ref|")
        return d.max().item()

    for shape, causal, window, dt, tol in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        got = flash_attention(q, k, v, causal=causal, window=window)
        check(got.dtype == dtype, f"flash_attention {shape} returns "
              f"{got.dtype}")
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        what = f"flash_attention {shape} causal={causal} window={window} {dt}"
        err = close(got, ref, tol, what)
        if dt == "float32":
            worst = max(worst, err)
        sp = fa.key_splits(shape[0], shape[2], shape[1], shape[1], shape[3])
        splits[shape] = sp
        detail(f"{what}: split {sp}, max |kernel - plain| {err:.2e}")
    # one shape below the threshold: the split forced off and on, two runs
    # of the split identical, and the merged output against the split's
    # plain version
    shape = (1, 512, 4, 64)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    auto = fa.key_splits(1, 4, 512, 512, 64)
    check(auto > 1, f"no key split at {shape}")
    for causal in (False, True):
        ref = flash_attention_ref(q, k, v, causal=causal)
        runs = {sp: fa._launch(q, k, v, causal=causal, window=0, splits=sp)
                for sp in (1, 2, auto)}
        again = fa._launch(q, k, v, causal=causal, window=0, splits=auto)
        check(torch.equal(runs[auto], again), f"flash_attention {shape} "
              f"causal={causal} split {auto}: two runs differ")
        for sp, got in runs.items():
            worst = max(worst, close(got, ref, 1e-4, f"flash_attention "
                                     f"{shape} causal={causal} split {sp}"))
            split_ref = fa.flash_attention_split_ref(q, k, v, causal=causal,
                                                     splits=sp)
            close(got, split_ref, 1e-4, f"flash_attention {shape} causal="
                  f"{causal} split {sp} against the split's plain version")
    q = torch.randn(1, 256, 8, 64, generator=gen, device=dev)
    k, v = (torch.randn(1, 256, 2, 64, generator=gen, device=dev)
            for _ in range(2))
    got = ops.attention(q, k, v, causal=True)
    ref = flash_attention_ref(q, k.repeat_interleave(4, 2),
                              v.repeat_interleave(4, 2), causal=True)
    worst = max(worst, close(got, ref, 1e-4, "ops.attention GQA"))
    n_split = sum(sp > 1 for sp in splits.values())
    report = (f"{len(FLASH_CASES)} shapes (head dims 16/32/64/128, ragged, "
              f"unaligned; {n_split} with a key split) and GQA within "
              f"tolerance; {shape} split 1/2/{auto}, causal and not, within "
              f"1e-4 of the plain version and of the split's, split "
              f"{auto} identical over two runs")
    return worst, report


FUSED_SHAPES = [(128, 256, 128), (256, 512, 384), (128, 1024, 256),
                (256, 512, 256)]
# shapes no 64x64 tile divides, rows that are not 16-byte aligned (the
# synchronous loads), odd N (scalar stores), split and unsplit
FUSED_RAGGED = [(1, 7, 3), (77, 1001, 19), (130, 514, 258)]


def fused_phase(dev, gen) -> tuple[float, str]:
    """Phase 10: fused_gemm_epilogue's kernel against its plain version
    at ``FUSED_SHAPES`` and ``FUSED_RAGGED``, every activation, with and
    without residual, float32 (1e-4) and bfloat16 (2e-2); at 256x512x256
    the K split forced off and left on, two runs of the split
    ``torch.equal``.  Returns (max float32 error, report)."""
    import torch
    from repro_torch.kernels import (fused_gemm_epilogue,
                                     fused_gemm_epilogue_ref)
    module = importlib.import_module("repro_torch.kernels.fused_gemm_epilogue")
    worst = 0.0

    def held(got, ref, dtype, tol, what):
        d = (got.float() - ref.float()).abs()
        ok = bool((d <= tol + tol * ref.float().abs()).all())
        check(got.dtype == dtype and got.shape == ref.shape and ok,
              f"fused_gemm_epilogue {what} {dtype}: max err "
              f"{d.max().item() if d.numel() else 0.0}")
        return d.max().item() if d.numel() else 0.0

    for M, K, N in FUSED_SHAPES + FUSED_RAGGED:
        x = torch.randn(M, K, generator=gen, device=dev)
        w = torch.randn(K, N, generator=gen, device=dev) * 0.05
        b = torch.randn(N, generator=gen, device=dev)
        r = torch.randn(M, N, generator=gen, device=dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            xd, wd = x.to(dtype), w.to(dtype)
            for act in ("none", "relu", "silu", "gelu"):
                for res in (None, r):
                    got = fused_gemm_epilogue(xd, wd, b, res, act=act)
                    ref = fused_gemm_epilogue_ref(xd, wd, b, act=act,
                                                  residual=res)
                    err = held(got, ref, dtype, tol, f"{M}x{K}x{N} {act} "
                               f"res={res is not None}")
                    if dtype == torch.float32:
                        worst = max(worst, err)
    splits = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.randn(256, 512, generator=gen, device=dev).to(dtype)
        w = (torch.randn(512, 256, generator=gen, device=dev) * .05).to(dtype)
        b = torch.randn(256, generator=gen, device=dev)
        r = torch.randn(256, 256, generator=gen, device=dev)
        auto = module.k_splits(256, 256, 512, x.element_size())[0]
        check(auto > 1, f"no K split at 256x512x256 {dtype}")
        ref = fused_gemm_epilogue_ref(x, w, b, act="silu", residual=r)
        for forced in (1, None):
            got = module._launch(x, w, b, r, "silu", splits=forced)
            err = held(got, ref, dtype, tol, f"256x512x256 split "
                       f"{'auto' if forced is None else forced}")
            if dtype == torch.float32:
                worst = max(worst, err)
        first = module._launch(x, w, b, r, "silu")
        again = module._launch(x, w, b, r, "silu")
        check(torch.equal(first, again), f"fused_gemm_epilogue split "
              f"{auto} {dtype}: two runs differ")
        splits.append(f"{str(dtype).split('.')[-1]} {auto}")
    n = (len(FUSED_SHAPES) + len(FUSED_RAGGED)) * 2 * 4 * 2
    return worst, (f"{n} cases ({len(FUSED_SHAPES)} shapes and ragged "
                   f"{', '.join('x'.join(map(str, t)) for t in FUSED_RAGGED)}"
                   f" x 4 activations x residual x float32/bfloat16) within "
                   f"tolerance; 256x512x256 K split ({', '.join(splits)}) "
                   "and unsplit within tolerance, two split runs torch.equal")


def packed_phase(dev, gen) -> tuple[float, str]:
    """Phase 11: packed_gemm's kernel against its plain version, and the
    grouped wrapper against the ``ref.py`` oracle, for the group sizes of
    ``tests/test_kernels.py`` (the second is the kernel bench's case),
    K=128, N=256, float32 (1e-4) and bfloat16 (2e-2); then block_m
    32/64/96 with a tile map that is not sorted.  Returns (max float32
    error, report)."""
    import torch
    from repro_torch.kernels import (ops, packed_gemm, packed_gemm_ref,
                                     packed_gemm_tiles_ref, pad_groups,
                                     tile_group_map)
    worst, n = 0.0, 0

    def held(a, b, tol, what):
        d = (a.float() - b.float()).abs()
        check(bool((d <= tol + tol * b.float().abs()).all()),
              f"packed_gemm {what}: max err {d.max().item()}")
        return d.max().item()

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for sizes in GROUP_SIZES:
            w = (torch.randn(len(sizes), 128, 256, generator=gen,
                             device=dev) * .1).to(dtype)
            x = torch.randn(sum(sizes), 128, generator=gen, device=dev
                            ).to(dtype)
            xp, padded, _, _ = pad_groups(x, sizes, 128)
            tiles = tile_group_map(padded, 128, xp.shape[0] // 128)
            got = packed_gemm(xp, w, tiles)
            check(got.dtype == dtype, f"packed_gemm returned {got.dtype}")
            for a, b in ((got, packed_gemm_tiles_ref(xp, w, tiles, 128)),
                         (ops.grouped_gemm(x, w, sizes),
                          packed_gemm_ref(x, w, sizes))):
                err = held(a, b, tol, f"{sizes} {dtype}")
                if dtype == torch.float32:
                    worst = max(worst, err)
                n += 1
        tiles = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
        for block_m in (32, 64, 96):
            w = (torch.randn(3, 128, 256, generator=gen, device=dev) * .1
                 ).to(dtype)
            x = torch.randn(4 * block_m, 128, generator=gen, device=dev
                            ).to(dtype)
            got = packed_gemm(x, w, tiles, block_m=block_m)
            err = held(got, packed_gemm_tiles_ref(x, w, tiles, block_m), tol,
                       f"block_m {block_m} map [2, 0, 2, 1] {dtype}")
            if dtype == torch.float32:
                worst = max(worst, err)
            n += 1
    return worst, (f"{n} cases: {len(GROUP_SIZES)} group-size lists, kernel "
                   "and grouped_gemm, and block_m 32/64/96 with the map "
                   "[2, 0, 2, 1], float32 within 1e-4 and bfloat16 within "
                   "2e-2")


# vit_tiny on the card against the CPU plain path.  Not bit-exact: the
# gelu, layer-norm and softmax epilogues differ from their plain versions
# by ulps (FB_CASES), and a flipped int8 value in the next quantization
# carries on.  The limits sit above what that gives (1.31e-3 relative
# logits at batches 1-16, seed 0) and at or below what the CPU tests hold
# the port to against JAX (2e-2 relative logits, 1e-3 probabilities).
VIT_REL = 1e-2
VIT_PROB_ATOL = 1e-3


def vit_phase(vit_dev, vit_cpu, rng) -> dict:
    """Phase 12: vit_tiny serving batches 1, 3, 16 (probs and logits),
    the launch counts read just after, against the CPU plain path.  Each
    request is its key's first, so ``run`` warms it up eagerly, captures
    its graph and replays it: the per-dynamic-stage launches are read in
    the warm-up (what every replay launches again), the totals from the
    counters (warm-ups and replays)."""
    import torch
    execute = importlib.import_module("repro_torch.program.execute")
    stages = vit_dev.program.stages()
    n_dyn = sum(g.kind == "dyn_gemm" for g, _ in stages)
    requests = [rng.standard_normal((b, 32, 32, 3)).astype("float32")
                for b in (1, 3, 16)]
    per_dyn = []
    dyn_stage = execute._dyn_stage

    def count_dyn(*args, **kw):
        before = _launch_counts()
        out = dyn_stage(*args, **kw)
        if not torch.cuda.is_current_stream_capturing():
            after = _launch_counts()
            per_dyn.append(tuple(after[w] - before[w]
                                 for w in PROGRAM_KERNELS))
        return out

    execute._dyn_stage = count_dyn
    try:
        served, launches = counted(
            lambda: [(vit_dev.run(x), vit_dev.run(x, logits=True))
                     for x in requests])
    finally:
        execute._dyn_stage = dyn_stage
    runs = 2 * len(requests)          # each its key's first: one warm-up
    want = forward_launches(vit_dev.program, 2 * runs)
    check(launches == want,
          f"vit_tiny launch counts {launches}, expected {want}")
    per_stage = tuple(2 if w == "quantize_layout" else 1
                      for w in PROGRAM_KERNELS)
    check(len(per_dyn) == n_dyn * runs
          and all(d == per_stage for d in per_dyn),
        f"vit_tiny dynamic stages launched {per_dyn}, expected {per_stage} "
        f"of {PROGRAM_KERNELS}")
    agree, worst_rel, worst_prob = [], 0.0, 0.0
    for x, (probs, logits) in zip(requests, served):
        ref = vit_cpu.run(x, logits=True)
        got, probs = logits.cpu(), probs.cpu()
        check(got.shape == (len(x), 10) and bool(torch.isfinite(got).all())
              and bool(torch.isfinite(probs).all()), "vit_tiny non-finite")
        check(bool(torch.allclose(probs.sum(1), torch.ones(len(x)),
                                  atol=1e-5)), "probabilities do not sum to 1")
        worst_rel = max(worst_rel, ((got - ref).abs().max()
                                    / ref.abs().max()).item())
        worst_prob = max(worst_prob,
                         (probs - vit_cpu.run(x)).abs().max().item())
        agree.append((got.argmax(1) == ref.argmax(1)).float().mean().item())
    check(min(agree) == 1.0, f"vit_tiny GPU vs CPU argmax agreement {agree}")
    check(worst_rel <= VIT_REL, f"vit_tiny GPU vs CPU relative logit error "
          f"{worst_rel:.2e} > {VIT_REL}")
    check(worst_prob <= VIT_PROB_ATOL, f"vit_tiny GPU vs CPU probabilities "
          f"differ by {worst_prob:.2e} > {VIT_PROB_ATOL}")
    return dict(launches=launches, n_dyn=n_dyn, n_stages=len(stages),
                agree=min(agree), rel=worst_rel, prob=worst_prob,
                dyn_runs=len(per_dyn))


# phase 12's further input draws of vit_tiny at batch 16 (seeds of
# numpy's default_rng), beside seed 0's requests
VIT_DRAWS = (1, 2, 3)


def fb_atol(kw: dict) -> float:
    """The ``FB_CASES`` tolerance of an epilogue call: the largest of its
    modes' (0: bit for bit)."""
    tol = 0.0
    if kw.get("act") == "gelu":
        tol = max(tol, 1e-6)
    if kw.get("softmax"):
        tol = max(tol, 1e-6)
    if kw.get("norm", "none") != "none" or kw.get("pool") == "seqmean":
        tol = max(tol, 1e-5)
    return tol


def record_stages(model, x) -> tuple:
    """``execute_packed(model.packed, x, return_logits=True)`` run eagerly
    (what ``model.run``'s graph replays for a batch that fills its
    bucket) with, per stage, the buffers the stage read, its
    ``quantize_layout`` calls (``quants``: input, K, keyword arguments
    and result of each; a dynamic stage's right operand, then its left
    one), its ``crossbar_gemm`` operands (x8, and ``w`` or, where the
    call passes none, ``wt``) and int32 output and its ``fb_epilogue``
    output and keyword arguments (``fb``), the tap and the partial maxima
    it left (``fb_tap``, ``fb_parts``: each None where the call stores
    none) and its int32 input and positional arguments (``fb_in``).  The
    buffers hold, beside a buffer, the partial maxima its epilogue left
    (``execute.parts_key``), and ``kw`` the stage's keyword arguments, so
    a stage run again from them takes the path the forward took.
    Returns (logits, records)."""
    import torch
    from repro_torch.kernels.fb_epilogue import split_outputs
    execute = importlib.import_module("repro_torch.program.execute")
    saved = (execute._static_stage, execute._dyn_stage,
             execute.crossbar_gemm, execute.fb_epilogue,
             execute.quantize_layout)
    recs: list[dict] = []

    def quant(xin, K, **kw):
        out = saved[4](xin, K, **kw)
        recs[-1]["quants"].append((xin, K, kw, out))
        return out

    def gemm(x8, w8=None, **kw):
        y = saved[2](x8, w8, **kw)
        recs[-1]["gemm"] = (x8, kw["wt"] if w8 is None else w8, y)
        return y

    def fb(y, *args, **kw):
        got = saved[3](y, *args, **kw)
        out, tap, parts = split_outputs(got, tap=kw.get("tap", False),
                                        partials=kw.get("partials", False))
        recs[-1].update(fb=(out, kw), fb_tap=tap, fb_parts=parts,
                        fb_in=(y, args))
        return got

    def static(*args, **kw):
        recs.append(dict(bufs=dict(args[3]), kw=kw, quants=[]))
        return saved[0](*args, **kw)

    def dyn(*args, **kw):
        recs.append(dict(bufs=dict(args[2]), kw=kw, quants=[]))
        return saved[1](*args, **kw)

    (execute._static_stage, execute._dyn_stage, execute.crossbar_gemm,
     execute.fb_epilogue, execute.quantize_layout) = (static, dyn, gemm, fb,
                                                      quant)
    try:
        logits = execute.execute_packed(
            model.packed, torch.as_tensor(x).to(model.device),
            return_logits=True)
    finally:
        (execute._static_stage, execute._dyn_stage, execute.crossbar_gemm,
         execute.fb_epilogue, execute.quantize_layout) = saved
    return logits, recs


def teacher_forced(vit_dev, recs) -> list[dict]:
    """Each stage of ``vit_dev`` run on the card from the CPU path's own
    input buffers (``recs`` from ``record_stages`` on the CPU model; the
    partial maxima the CPU's epilogues left among them, so a stage whose
    forward took them takes them here too): its int32 GEMM output
    against the CPU's (``torch.equal``), its FB output against the CPU's,
    to the ``FB_CASES`` tolerance of its modes, and where its epilogue
    leaves partial maxima, their maximum against ``max |FB output|``
    (``parts_equal``: ``torch.equal``; None where it leaves none)."""
    import torch
    from repro_torch.kernels.fb_epilogue import split_outputs
    execute = importlib.import_module("repro_torch.program.execute")
    saved = execute.crossbar_gemm, execute.fb_epilogue
    got: dict = {}

    def gemm(x8, w8=None, **kw):
        got["y"] = saved[0](x8, w8, **kw)
        return got["y"]

    def fb(y, *args, **kw):
        res = saved[1](y, *args, **kw)
        got["fb"], _, got["parts"] = split_outputs(
            res, tap=kw.get("tap", False), partials=kw.get("partials", False))
        return res

    def to_dev(v):
        return v.to(vit_dev.device) if isinstance(v, torch.Tensor) else v

    out = []
    cfg = vit_dev.program.cfg
    stages = zip(vit_dev.program.stages(), vit_dev.packed.stages, recs)
    execute.crossbar_gemm, execute.fb_epilogue = gemm, fb
    try:
        for (op, posts), st, rec in stages:
            bufs = {k: to_dev(v) for k, v in rec["bufs"].items()}
            kw = {k: to_dev(v) for k, v in rec["kw"].items()}
            if op.kind == "dyn_gemm":
                execute._dyn_stage(op, posts, bufs, cfg, **kw)
            else:
                execute._static_stage(op, posts, st, bufs, cfg, **kw)
            ref_fb, fkw = rec["fb"]
            err = (got["fb"].cpu() - ref_fb).abs().max().item()
            parts = got["parts"]
            out.append(dict(name=op.name, gemm_equal=torch.equal(
                got["y"].cpu(), rec["gemm"][2]), fb_err=err,
                fb_atol=fb_atol(fkw), parts_equal=None if parts is None
                else torch.equal(parts.max(), got["fb"].abs().max())))
    finally:
        execute.crossbar_gemm, execute.fb_epilogue = saved
    return out


def vit_draws_phase(vit_dev, vit_cpu) -> dict:
    """Phase 12, continued: vit_tiny at batch 16 on the ``VIT_DRAWS``
    inputs, each draw's max relative logit gap to the CPU path and argmax
    agreement (printed, not held: the gap depends on the draw); then on
    the draw with the largest gap, every stage teacher-forced from the
    CPU path's buffers (int32 GEMM outputs ``torch.equal``, FB outputs
    within ``FB_CASES``' tolerances, both held), and, in the free-running
    GPU forward, the int8 GEMM operands that differ from the CPU path's,
    stage by stage."""
    import numpy as np
    import torch
    draws = []
    for seed in VIT_DRAWS:
        x = np.random.default_rng(seed).standard_normal(
            (16, 32, 32, 3)).astype(np.float32)
        got = vit_dev.run(x, logits=True).cpu()
        ref = vit_cpu.run(x, logits=True)
        check(bool(torch.isfinite(got).all()), "vit_tiny non-finite logits")
        draws.append(dict(seed=seed, x=x, rel=((got - ref).abs().max()
                                               / ref.abs().max()).item(),
                          agree=(got.argmax(1) == ref.argmax(1)).float()
                          .mean().item()))
    worst = max(draws, key=lambda d: d["rel"])
    _, cpu_recs = record_stages(vit_cpu, worst["x"])
    forced = teacher_forced(vit_dev, cpu_recs)
    for f in forced:
        check(f["gemm_equal"], f"vit_tiny teacher-forced stage {f['name']}: "
              "the int32 GEMM output differs from the CPU path's")
        check(f["fb_err"] <= f["fb_atol"], f"vit_tiny teacher-forced stage "
              f"{f['name']}: FB output off by {f['fb_err']:.2e} > "
              f"{f['fb_atol']}")
        check(f["parts_equal"] is not False, f"vit_tiny teacher-forced "
              f"stage {f['name']}: the partial maxima the epilogue left "
              "do not reduce to max |FB output|")
    _, gpu_recs = record_stages(vit_dev, worst["x"])
    flips = []
    for op_rec, cpu_rec, f in zip(gpu_recs, cpu_recs, forced):
        n = sum(int((a.cpu() != b).sum()) for a, b in
                zip(op_rec["gemm"][:2], cpu_rec["gemm"][:2])
                if a.dtype == torch.int8)
        flips.append((f["name"], n, (op_rec["fb"][0].cpu()
                                     - cpu_rec["fb"][0]).abs().max().item()))
    for name, n, d in flips:
        detail(f"vit_tiny draw {worst['seed']} free run, stage {name}: "
               f"{n} int8 GEMM operands differ from the CPU path's, FB "
               f"output max |GPU - CPU| {d:.2e}")
    return dict(draws=draws, worst=worst["seed"], forced=forced,
                flips=flips)


def attention_graph(api):
    """The attention bench's geometry: one attention(4) layer, dim 64."""
    nb = api.NetworkBuilder("attn_prefill", input_seq_dim=64)
    nb.attention(4, name="attn")
    return nb.build()


def attention_phase(model, dev, gen) -> tuple[dict, list]:
    """Phase 13: crossbar attention through ``run`` against
    ``ops.attention`` on the same projected q/k/v (non-causal), then the
    same output projection.  Returns the flash launch count of the
    driven calls and, per T, (x, q, k, v, rel, corr)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.program.sequence import split_qkv_heads
    p = model.params["attn"]
    cases = []
    before = launches_of(flash_attention)
    for T in ATTN_T:
        x = torch.randn(1, T, 64, generator=gen, device=dev)
        y_cb = model.run(x)
        qkv = (x.reshape(-1, 64) @ p["wqkv"] + p["bqkv"]).reshape(1, T, -1)
        q, k, v = (u.reshape(1, 4, T, 16).transpose(1, 2).contiguous()
                   for u in split_qkv_heads(qkv, 4))
        ctx = ops.attention(q, k, v, causal=False)
        y_fl = ctx.reshape(1, T, 64) @ p["wo"] + p["bo"]
        a, b = y_cb.cpu().numpy().ravel(), y_fl.cpu().numpy().ravel()
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        corr = float(np.corrcoef(a, b)[0, 1])
        check(rel < 0.12 and corr > 0.99, f"crossbar attention T={T} vs "
              f"flash_attention: rel {rel}, corr {corr}")
        cases.append((T, x, q, k, v, rel, corr))
    n = launches_of(flash_attention) - before
    check(n == len(ATTN_T), f"attention path: flash_attention launched "
          f"{n} times, expected {len(ATTN_T)}")
    return {"flash_attention": n}, cases


def ops_phase(dev, gen) -> dict:
    """Phase 14: ``kernels.ops``' five wrappers at the kernel bench's
    shapes; each launches its kernel once and agrees with its plain
    version.  Returns the launch counts read just after."""
    import torch
    from repro_torch.kernels import (crossbar_gemm, crossbar_gemm_ref,
                                     fb_epilogue, fb_epilogue_ref,
                                     flash_attention, flash_attention_ref,
                                     fused_gemm_epilogue,
                                     fused_gemm_epilogue_ref, ops,
                                     packed_gemm, packed_gemm_ref)
    x8 = torch.randint(-128, 128, (128, 512), generator=gen, device=dev,
                       dtype=torch.int8)
    w8 = torch.randint(-128, 128, (512, 256), generator=gen, device=dev,
                       dtype=torch.int8)
    q, k, v = (torch.randn(1, 512, 4, 64, generator=gen, device=dev)
               for _ in range(3))
    xf = torch.randn(256, 512, generator=gen, device=dev)
    wf = torch.randn(512, 256, generator=gen, device=dev) * 0.05
    bf = torch.zeros(256, device=dev)
    sizes = GROUP_SIZES[1]
    wg = torch.randn(4, 128, 256, generator=gen, device=dev) * 0.1
    xg = torch.randn(sum(sizes), 128, generator=gen, device=dev)
    scale = torch.full((1, 1), 2.5e-5, device=dev)
    kernels = (crossbar_gemm, fb_epilogue, flash_attention,
               fused_gemm_epilogue, packed_gemm)
    torch.cuda.synchronize()
    before = _launch_counts()
    y = ops.crossbar_matmul_int8(x8, w8, rows=256)
    post = ops.fb_postops(y, scale, bf, act="relu")
    att = ops.attention(q, k, v)
    lin = ops.linear_fused(xf, wf, bf, act="silu")
    grp = ops.grouped_gemm(xg, wg, sizes)
    torch.cuda.synchronize()
    after = _launch_counts()
    launches = {k.__name__: after[k.__name__] - before[k.__name__]
                for k in kernels}
    check(all(n == 1 for n in launches.values()),
          f"ops entry point launches {launches}, expected 1 each")
    check(torch.equal(y, crossbar_gemm_ref(x8, w8, rows=256)),
          "ops.crossbar_matmul_int8 differs")
    check(torch.equal(post, fb_epilogue_ref(y, scale, bf, act="relu")),
          "ops.fb_postops differs")
    for name, got, ref in (
            ("attention", att, flash_attention_ref(q, k, v)),
            ("linear_fused", lin, fused_gemm_epilogue_ref(xf, wf, bf)),
            ("grouped_gemm", grp, packed_gemm_ref(xg, wg, sizes))):
        d = (got - ref).abs()
        check(bool((d <= 1e-4 + 1e-4 * ref.abs()).all()),
              f"ops.{name}: max |kernel - plain| {d.max().item()}")
    return launches


# ---------------------------------------------------------------------------
# phases 16-20: the rest of repro_torch.api on the card
# ---------------------------------------------------------------------------

# the program path's kernels: every stage launches one of each, and a
# dynamic (attention) stage a second quantize_layout (its right operand)
PROGRAM_KERNELS = ("crossbar_gemm", "fb_epilogue", "quantize_layout")


def each(n: int) -> dict:
    """``n`` launches of each of ``PROGRAM_KERNELS``."""
    return dict.fromkeys(PROGRAM_KERNELS, n)


def forward_launches(program, runs: int = 1) -> dict:
    """The program kernels' launches in ``runs`` forwards of ``program``:
    one ``crossbar_gemm`` and one ``fb_epilogue`` a stage, one
    ``quantize_layout`` a static stage and two a dynamic one."""
    stages = program.stages()
    n_dyn = sum(g.kind == "dyn_gemm" for g, _ in stages)
    return dict(crossbar_gemm=len(stages) * runs,
                fb_epilogue=len(stages) * runs,
                quantize_layout=(len(stages) + n_dyn) * runs)


def _launch_counts() -> dict:
    """Each of the six kernel wrappers' launches so far, by name
    (``launches.<wrapper>`` in ``repro_torch.trace``: every eager call
    and key warm-up, and each replay what its recording counted)."""
    from repro_torch import trace
    from repro_torch.kernels._build import SOURCES
    counters = trace.counters()
    return {w: counters.get(f"launches.{w}", 0) for w in SOURCES}


def launches_of(fn) -> int:
    """A kernel wrapper's launches so far (``_launch_counts``)."""
    return _launch_counts()[fn.__name__]


def counted(fn) -> tuple:
    """(fn(), launches): the program kernels' launches while ``fn`` runs
    (device synchronized on both sides).  A ``run`` that is its key's
    first counts the key's warm-up and its replay."""
    import torch
    torch.cuda.synchronize()
    before = _launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = _launch_counts()
    return out, {w: after[w] - before[w] for w in PROGRAM_KERNELS}


def vgg_phase(api, rng) -> dict:
    """Phase 16: VGG-16 at full width serving batches 1 and 16 (probs and
    logits), logits ``torch.equal`` to the CPU plain path's (a ReLU / max
    pool chain: every quantization sees the same values)."""
    import torch
    gpu = api.compile("vgg16", api.HurryConfig(), seed=0, device="cuda")
    cpu = api.compile("vgg16", api.HurryConfig(), seed=0, device="cpu")
    n_stages = len(gpu.program.stages())
    requests = [rng.standard_normal((b, 32, 32, 3)).astype("float32")
                for b in (1, 16)]
    served, launches = counted(lambda: [(gpu.run(x), gpu.run(x, logits=True))
                                        for x in requests])
    # each run its key's first: its warm-up and its replay
    want = n_stages * 4 * len(requests)
    check(launches == each(want),
          f"VGG-16 launch counts {launches}, expected {want} each")
    for x, (probs, logits) in zip(requests, served):
        ref = cpu.run(x, logits=True)
        got, probs = logits.cpu(), probs.cpu()
        check(got.shape == (len(x), 10) and bool(torch.isfinite(got).all())
              and bool(torch.isfinite(probs).all()), "VGG-16 non-finite")
        check(torch.equal(got, ref), f"VGG-16 batch {len(x)}: GPU logits "
              f"differ from the CPU plain path by up to "
              f"{(got - ref).abs().max().item():.3e}")
        check(bool(torch.allclose(probs, cpu.run(x), atol=1e-6)),
              "VGG-16 probabilities differ from the CPU plain path")
    ms = {}
    for b in (1, 16):
        xb = torch.from_numpy(requests[b > 1]).cuda()
        ms[b] = wall_ms(lambda: gpu.run(xb))
    return dict(launches=launches, n_stages=n_stages, ms=ms)


def save_load_phase(api, models: dict, gen) -> dict:
    """Phase 17: each model (compiled on the card) saved to a temporary
    file and loaded back onto the card; batch-16 ``run`` of the loaded
    model ``torch.equal`` to the in-memory one's.  The seconds of a fresh
    ``compile`` beside ``load``, and the file's size."""
    import tempfile
    import torch
    out, launches = {}, each(0)
    with tempfile.TemporaryDirectory() as d:
        for name, model in models.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.compile(name, model.config, seed=0, device="cuda")
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            path = model.save(os.path.join(d, f"{name}.npz"))
            t0 = time.perf_counter()
            loaded = api.load(path, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            x = torch.randn(model.program.input_shape(16), generator=gen,
                            device="cuda")
            got, n = counted(lambda: (loaded.run(x), loaded.run(
                x, logits=True)))
            # two keys' first requests: each its warm-up and its replay
            want = forward_launches(model.program, 4)
            check(n == want,
                  f"loaded {name}: launch counts {n}, expected {want}")
            check(torch.equal(got[0], model.run(x))
                  and torch.equal(got[1], model.run(x, logits=True)),
                  f"loaded {name} differs from the in-memory model")
            for k in launches:
                launches[k] += n[k]
            out[name] = dict(compile_s=compile_s, load_s=load_s,
                             mb=os.path.getsize(path) / 2 ** 20)
    return dict(models=out, launches=launches)


def server_phase(api, model, rng) -> dict:
    """Phase 18: ``make_server("resnet18")`` (the zoo init from seed 0,
    the weights of ``model``) at batches 1, 3 and 16, ``torch.equal`` to
    ``CompiledModel.run``; the three counters grow by one per stage and
    request and key warm-up.  Time per batch at 16 beside ``run``'s."""
    import torch
    from repro_torch.program.serve import make_server
    server = make_server("resnet18", config=api.HurryConfig(), seed=0,
                         device="cuda")
    requests = [torch.from_numpy(rng.standard_normal(
        (b, 32, 32, 3)).astype("float32")).cuda() for b in (1, 3, 16)]
    answers, launches = counted(lambda: [server(x) for x in requests])
    # each request its key's first: its warm-up and its replay
    want = len(server.program.stages()) * 2 * len(requests)
    check(launches == each(want),
          f"server launch counts {launches}, expected {want} each")
    for x, a in zip(requests, answers):
        check(torch.equal(a, model.run(x)),
              f"server batch {len(x)} differs from CompiledModel.run")
    x16 = requests[-1]
    return dict(launches=launches, ms=wall_ms(lambda: server(x16)),
                run_ms=wall_ms(lambda: model.run(x16)))


# (rows, adc_bits, K) of phase 19's crossbar_matmul calls: both branches,
# ragged K, one chunk and many
XBAR_CASES = [(512, 9, 27), (512, 9, 1001), (494, 9, 4860), (494, 8, 1001),
              (256, 9, 777), (255, 8, 300), (512, 8, 2470)]
NOISE_REL = 0.15


def _noise_rel(x, w, cfg, device, draws: int = 4) -> float:
    """mean |noisy - exact| / mean |exact| over ``draws`` seeded draws."""
    import torch
    from repro_torch.core.crossbar import crossbar_matmul
    x, w = x.to(device), w.to(device)
    exact = (x.double() @ w.double())
    errs = [(crossbar_matmul(x, w, cfg, torch.Generator(device)
                             .manual_seed(7 + i)).double() - exact)
            .abs().mean().item() for i in range(draws)]
    return sum(errs) / draws / exact.abs().mean().item()


def functional_phase(api, pairs: dict, rng) -> dict:
    """Phase 19: ``crossbar_matmul`` on the card against the CPU
    (``torch.equal``, one ``crossbar_gemm`` launch per call, both
    branches, leading dims and a slice axis), the read-noise statistic
    on the card against the CPU's, and ``graph.forward`` with the
    crossbar ``mm`` at batch 16 against the same call on the CPU.
    ``pairs`` maps a net to (card model, CPU model, relative logit
    limit, probability limit, whether argmax agreement 1.0 is held)."""
    import torch
    from repro_torch.core.crossbar import CrossbarConfig, crossbar_matmul
    from repro_torch.kernels import clip_possible, softmax_rows
    from repro_torch.models.cnn import make_crossbar_matmul
    branches = {"exact": 0, "sliced": 0}
    for rows, adc, K in XBAR_CASES:
        x = torch.from_numpy(rng.integers(-300, 300, (2, 5, K),
                                          dtype="int32"))
        w = torch.from_numpy(rng.integers(-300, 300, (K, 19), dtype="int32"))
        x[0, :2] = -1
        w[:, :5] = -1
        cfg = CrossbarConfig(rows=rows, adc_bits=adc)
        for a, b in [(x, w), (x[1][None].expand(3, -1, -1).contiguous(),
                              w[None].expand(3, -1, -1).contiguous())]:
            got, n = counted(lambda: crossbar_matmul(a.cuda(), b.cuda(), cfg))
            check(n["crossbar_gemm"] == 1, f"crossbar_matmul launched {n}")
            check(torch.equal(got.cpu(), crossbar_matmul(a, b, cfg)),
                  f"crossbar_matmul rows {rows} adc {adc} K {K} shape "
                  f"{tuple(a.shape)}: card differs from the CPU")
            branches["sliced" if clip_possible(min(rows, K), adc)
                     else "exact"] += 1
    xn = torch.from_numpy(rng.integers(-128, 128, (8, 256), dtype="int32"))
    wn = torch.from_numpy(rng.integers(-128, 128, (256, 32), dtype="int32"))
    noise = {}
    for sigma in (0.5, 2.0):
        cfg = CrossbarConfig(rows=256, noise_sigma_thermal=sigma)
        (g, c), n = counted(lambda: (_noise_rel(xn, wn, cfg, "cuda"),
                                     _noise_rel(xn, wn, cfg, "cpu")))
        check(n["crossbar_gemm"] == 0 and g > 0
              and abs(g - c) <= NOISE_REL * c,
              f"noise sigma {sigma}: card {g:.4e}, CPU {c:.4e}, {n}")
        noise[sigma] = (g, c)
    check(noise[0.5][0] < noise[2.0][0], f"noise not monotone: {noise}")
    fwd = {}
    for name, (gpu, cpu, rel_lim, prob_lim, hold_argmax) in pairs.items():
        mm = make_crossbar_matmul(gpu.config.crossbar())
        x = rng.standard_normal(gpu.program.input_shape(16)).astype(
            "float32")
        xg, xc = torch.from_numpy(x).cuda(), torch.from_numpy(x)
        (logits, probs), n = counted(lambda: (
            gpu.graph.forward(gpu.params, xg, mm=mm, logits=True),
            gpu.graph.forward(gpu.params, xg, mm=mm)))
        want = 2 * len(gpu.program.stages())
        check(n == dict(each(0), crossbar_gemm=want),
              f"{name} forward launches {n}, expected {want} crossbar_gemm")
        ref = cpu.graph.forward(cpu.params, xc, mm=mm, logits=True)
        ref_p = softmax_rows(ref)        # the graph's last layer, on ref
        got = logits.cpu()
        check(bool(torch.isfinite(got).all()) and got.shape == (16, 10),
              f"{name} forward non-finite")
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        flips = got.argmax(1) != ref.argmax(1)
        agree = 1.0 - flips.float().mean().item()
        top2 = ref.topk(2, dim=1).values
        margins = ((top2[:, 0] - top2[:, 1]) / ref.abs().max())[flips]
        prob = (probs.cpu() - ref_p).abs().max().item()
        check((agree == 1.0 or not hold_argmax) and rel <= rel_lim
              and prob <= prob_lim,
              f"{name} forward card vs CPU: agreement {agree}, rel {rel:.2e}"
              f" (limit {rel_lim}), probs {prob:.2e} (limit {prob_lim})")
        run_gap = ((logits - gpu.run(xg, logits=True)).abs().max()
                   / logits.abs().max()).item()
        fwd[name] = dict(launches=n["crossbar_gemm"] // 2, rel=rel,
                         prob=prob, exact=torch.equal(got, ref), agree=agree,
                         margins=[f"{m:.2e}" for m in margins.tolist()],
                         run_gap=run_gap,
                         ms=wall_ms(lambda: gpu.graph.forward(
                             gpu.params, xg, mm=mm, logits=True)),
                         run_ms=wall_ms(lambda: gpu.run(xg, logits=True)),
                         total=n["crossbar_gemm"])
    return dict(branches=branches, noise=noise, forward=fwd)


# ---------------------------------------------------------------------------
# phase 21: the LM serving stack (repro_torch.models.lm, serve/) on the card
# ---------------------------------------------------------------------------

LM_TOL = 1e-4           # card against CPU, relative to max |logit|
LM_STEPS = 16           # teacher-forced decode steps of (a)
RING = dict(window=8, steps=24)           # Mixtral's ring buffer in (a)
QWEN_DEPTH2 = dict(batch=2, seq=64)       # (b)
QWEN_TEACHER = dict(batch=2, steps=128)   # (c)
# (c): tests/test_archs_smoke.py's decode-against-forward thresholds
QWEN_AGREE, QWEN_CORR = 0.95, 0.98
QWEN_SERVE = dict(prefill=4096, batch=8, prompt=128, new=64)   # (d)
# where the eager decode step is not repeatable (a second eager loop
# differs from the first), the replay may differ from the eager step by at
# most this many times the largest gap of the two eager loops
REPLAY_GAP_FACTOR = 2.0


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def lm_logits(cfg, params, tokens, frames, steps: int, compute):
    """Forward logits, encoder states (or None) and the logits of ``steps``
    teacher-forced ``decode_step``s over the same tokens."""
    import torch
    from repro_torch.models import lm
    fwd = lm.forward(params, cfg, tokens, encoder_input=frames,
                     compute_dtype=compute)
    states = (None if frames is None
              else lm.encode(params, cfg, frames, compute))
    caches = lm.init_caches(cfg, tokens.shape[0], steps, dtype=compute,
                            params=params)
    outs = []
    for i in range(steps):
        lg, caches = lm.decode_step(params, cfg, tokens[:, i:i + 1], caches,
                                    i, encoder_states=states,
                                    compute_dtype=compute)
        outs.append(lg)
    return fwd, states, torch.cat(outs, 1)


def _rel(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def decode_replay(cfg, params, prompt, new: int, states=None,
                  repeat: bool = False) -> dict:
    """The greedy loop of ``greedy_generate`` (the prompt teacher-forced,
    then ``new`` tokens) through the eager ``make_decode_step`` and
    through ``compile_decode_step`` in lockstep, both fed the eager
    loop's tokens, each step's ids and logits compared (``torch.equal``;
    the first step that differs and each step's gap to max |logit|).
    The compiled step decodes on its own caches, unless ``repeat``: then
    at every step it and a second eager step both start from the eager
    loop's caches (the compiled step copies them in), so that the
    second eager step's gap to the first is the eager step's own
    repeatability on the same inputs.  Then one replayed step timed
    (``wall_ms``, median of 5) and profiled on the executable's own
    caches, the capture seconds and the bytes of the cache tree (the
    graph copies each new leaf back: twice these bytes a step)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve.step import compile_decode_step, make_decode_step
    B, P = prompt.shape
    L = P + new
    eager, compiled = make_decode_step(cfg), compile_decode_step(cfg)
    init = lm.init_caches(cfg, B, L, params=params)
    pos = torch.arange(L, dtype=torch.int32, device=prompt.device)
    caches = dict(eager=init, compiled=init)
    out = dict(steps=L - 1, first_diff=None, eager_first_diff=None,
               gaps=[], eager_gaps=[], agree=0.0, eager_agree=0.0)

    def compare(key, nxt, logits, n_x, l_x, i):
        if not (torch.equal(n_x, nxt) and torch.equal(l_x, logits)):
            if out[f"{key}first_diff"] is None:
                out[f"{key}first_diff"] = i
        out[f"{key}gaps"].append(_rel(l_x, logits))
        out[f"{key}agree"] += (n_x == nxt).float().mean().item() / (L - 1)

    tok = prompt[:, :1]
    for i in range(L - 1):
        before = caches["eager"]
        nxt, logits, caches["eager"] = eager(params, tok, before, pos[i],
                                             encoder_states=states)
        n_c, l_c, caches["compiled"] = compiled(
            params, tok, before if repeat else caches["compiled"], pos[i],
            encoder_states=states)
        compare("", nxt, logits, n_c, l_c, i)
        if repeat:
            n_r, l_r, _ = eager(params, tok, before, pos[i],
                                encoder_states=states)
            compare("eager_", nxt, logits, n_r, l_r, i)
        tok = prompt[:, i + 1:i + 2] if i + 1 < P else nxt
    out["gap"] = max(out["gaps"])
    out["eager_gap"] = max(out["eager_gaps"], default=0.0)
    (exe,) = compiled.executables.values()
    own = caches["compiled"]
    step = lambda: compiled(params, tok, own, pos[P],      # noqa: E731
                            encoder_states=states)
    out["capture_s"] = exe.capture_s
    out["ms"] = wall_ms(step, runs=5)
    out["busy"], out["top"] = forward_profile(step, runs=3, top=None)
    out["launches"] = sum(n for _, n, _ in out["top"])
    out["tok_s"] = B / out["ms"] * 1e3
    out["cache_gb"] = sum(t.numel() * t.element_size()
                          for t in _tree_leaves(own)) / 1e9
    out["keys"] = len(compiled.executables)
    del caches, own, exe, compiled
    torch.cuda.empty_cache()
    return out


def replay_held(name: str, r: dict) -> None:
    """Fails unless the replayed loop equals the eager one; where the
    eager step itself is not repeatable (``repeat``), each replayed
    step is held to ``REPLAY_GAP_FACTOR`` times the largest gap of two
    eager steps on the same inputs over the loop."""
    if r["eager_first_diff"] is None:
        check(r["first_diff"] is None,
              f"{name}: replayed decode step {r['first_diff']} differs from "
              f"the eager step (max rel {r['gap']:.2e})")
    else:
        check(r["gap"] <= REPLAY_GAP_FACTOR * r["eager_gap"],
              f"{name}: replay vs eager {r['gap']:.2e} over "
              f"{REPLAY_GAP_FACTOR} x eager vs eager {r['eager_gap']:.2e}")
    check(r["keys"] == 1, f"{name}: {r['keys']} keys captured, expected 1")


def replay_text(r: dict, eager_ms: float, floor: float) -> str:
    """A replayed step beside the eager one and the floor."""
    busy = ("busy not measured" if r["busy"] is None
            else f"{r['busy']:.3f} ms busy, idle {1 - r['busy'] / r['ms']:.1%}"
            f", {r['launches']} kernels")
    held = ("ids and logits torch.equal to eager over "
            f"{r['steps']} steps" if r["first_diff"] is None else
            f"replay first differs at step {r['first_diff']}, max rel "
            f"{r['gap']:.2e}, next-token agreement {r['agree']:.4f}; eager "
            f"vs eager on the same inputs first differs at "
            f"{r['eager_first_diff']}, max rel {r['eager_gap']:.2e}, "
            f"agreement {r['eager_agree']:.4f}")
    # the graph's copy-back reads each new cache leaf and writes it again
    copy_ms = 2 * r["cache_gb"] * 1e9 / HBM_BYTES_PER_S * 1e3
    return (f"replayed step {r['ms']:.3f} ms ({busy}) = {r['tok_s']:.1f} "
            f"tok/s, {eager_ms / r['ms']:.1f}x under eager {eager_ms:.3f} ms, "
            f"{r['ms'] / floor:.1f}x floor {floor:.3f} ("
            f"{r['ms'] / (floor + copy_ms):.1f}x {floor + copy_ms:.3f} with "
            f"the copy-back of the {r['cache_gb']:.3f} GB cache tree); "
            f"capture {r['capture_s']:.3f} s; {held}")


def lm_reduced(dev) -> dict:
    """(a): every arch at ``reduced()`` (and Mixtral with its window cut to
    ``RING['window']``, decoded ``RING['steps']`` steps through the ring
    buffer) on the card against the CPU on the same float32 weights."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import lm
    cases = [(a, get_config(a).reduced(), LM_STEPS) for a in ARCH_IDS]
    cases.append(("mixtral_8x22b ring", dataclasses.replace(
        get_config("mixtral_8x22b").reduced(),
        sliding_window=RING["window"]), RING["steps"]))
    errs = {}
    for i, (name, cfg, steps) in enumerate(cases):
        gen = torch.Generator().manual_seed(i)
        params = lm.init_params(cfg, gen, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, steps), generator=gen)
        frames = (torch.randn((2, cfg.encoder_seq, cfg.d_model),
                              generator=gen) if cfg.is_encdec else None)
        f32 = torch.float32
        want = lm_logits(cfg, params, tokens, frames, steps, f32)
        got = lm_logits(cfg, _tree(lambda t: t.to(dev), params),
                        tokens.to(dev),
                        None if frames is None else frames.to(dev), steps,
                        f32)
        e = {part: _rel(g, w) for part, g, w in
             zip(("forward", "encode", "decode"), got, want)
             if w is not None}
        for part, g in zip(("forward", "encode", "decode"), got):
            check(g is None or bool(torch.isfinite(g).all()),
                  f"{name} {part}: non-finite on the card")
        check(all(v <= LM_TOL for v in e.values()),
              f"{name} card vs CPU {e} (limit {LM_TOL})")
        errs[name] = e
        detail(f"  21a {name}: " + ", ".join(
            f"{k} {v:.2e}" for k, v in e.items()))
    return errs


def _full(arch: str, n_layers: int | None = None, **kw):
    """``arch``'s published config, its depth cut to ``n_layers`` (and
    any other field replaced by ``kw``)."""
    import dataclasses
    from repro_torch.configs import get_config
    if n_layers is not None:
        kw["n_layers"] = n_layers
    return dataclasses.replace(get_config(arch), **kw)


def qwen_depth2(dev) -> float:
    """(b): Qwen3-8B at full width, depth 2, float32: forward logits on
    the card against the CPU on the same weights."""
    import torch
    from repro_torch.models import lm
    cfg = _full("qwen3_8b", 2)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    b, s = QWEN_DEPTH2["batch"], QWEN_DEPTH2["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    got = lm.forward(params, cfg, tokens, compute_dtype=torch.float32)
    got = got.cpu()
    params = _tree(lambda t: t.cpu(), params)
    want = lm.forward(params, cfg, tokens.cpu(), compute_dtype=torch.float32)
    err = _rel(got, want)
    check(bool(torch.isfinite(got).all()) and err <= LM_TOL,
          f"qwen3_8b depth 2 card vs CPU {err:.2e} (limit {LM_TOL})")
    return err


def _agreement(fwd, dec) -> tuple[float, float]:
    import numpy as np
    f, d = fwd.float().cpu(), dec.float().cpu()
    agree = (f.argmax(-1) == d.argmax(-1)).float().mean().item()
    corr = float(np.corrcoef(f.numpy().ravel(), d.numpy().ravel())[0, 1])
    return agree, corr


def qwen_full_f32(dev) -> dict:
    """(c): Qwen3-8B at full width and depth, float32 parameters:
    ``QWEN_TEACHER['steps']`` teacher-forced decode steps against the
    forward on the same tokens, in bfloat16 compute (the default, as in
    tests/test_archs_smoke.py) and in float32."""
    import torch
    from repro_torch.models import lm
    cfg = _full("qwen3_8b")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    gb = sum(t.numel() * t.element_size()
             for t in _tree_leaves(params)) / 1e9
    b, s = QWEN_TEACHER["batch"], QWEN_TEACHER["steps"]
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(dev).manual_seed(2))
    out = {"gb": gb}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        t0 = time.perf_counter()
        fwd, _, dec = lm_logits(cfg, params, tokens, None, s, dtype)
        agree, corr = _agreement(fwd, dec)
        out[name] = dict(agree=agree, corr=corr, rel=_rel(dec, fwd),
                         finite=bool(torch.isfinite(dec).all()),
                         s=time.perf_counter() - t0)
        detail(f"  21c qwen3_8b 36 layers {name} compute: decode vs "
               f"forward agreement {agree:.4f}, correlation {corr:.6f}, "
               f"max rel {out[name]['rel']:.2e}, "
               f"{out[name]['s']:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


def qwen_serve(dev) -> dict:
    """(d): Qwen3-8B, full width and depth, bfloat16 parameters, served:
    ``make_prefill_step`` at batch 1 over ``QWEN_SERVE['prefill']``
    tokens (the chunked attention) and ``greedy_generate`` at batch 8
    (128-token prompt, 64 new tokens), each timed by ``wall_ms`` beside
    its floor worked out from the code's work."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve.step import (greedy_generate, make_decode_step,
                                        make_prefill_step)
    cfg = _full("qwen3_8b")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            dtype=torch.bfloat16, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    leaves = list(_tree_leaves(params))
    weight_b = sum(t.numel() * t.element_size() for t in leaves)
    embed_b = params["embed"].numel() * params["embed"].element_size()
    gen = torch.Generator(dev).manual_seed(3)
    S = QWEN_SERVE["prefill"]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    prompt_long = torch.randint(0, cfg.vocab_size, (1, S), device=dev,
                                generator=gen)
    prefill = make_prefill_step(cfg)
    last = prefill(params, prompt_long)
    check(last.shape == (1, cfg.padded_vocab)
          and bool(torch.isfinite(last).all()),
          f"prefill logits {tuple(last.shape)} not finite")
    prefill_ms = wall_ms(lambda: prefill(params, prompt_long), runs=5)
    # every matrix parameter but the embedding table takes part in a
    # product for each token; attention scores and P.V run over all S
    # keys (mha_chunked computes each query chunk against every key)
    mat_params = sum(t.numel() for t in leaves if t.ndim >= 2) \
        - params["embed"].numel()
    prefill_flop = 2 * S * mat_params + cfg.n_layers * 4 * h * S * S * hd
    prefill_floor = max(prefill_flop / BF16_OPS_PER_S,
                        (weight_b - embed_b) / HBM_BYTES_PER_S) * 1e3
    prefill_busy, prefill_top = forward_profile(
        lambda: prefill(params, prompt_long), runs=1)
    del last

    B, P, N = QWEN_SERVE["batch"], QWEN_SERVE["prompt"], QWEN_SERVE["new"]
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=gen, dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompt, N)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    check(out.shape == (B, P + N) and torch.equal(out[:, :P], prompt)
          and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"greedy_generate output {tuple(out.shape)} wrong")
    # the first generated token against the prefill's argmax on the same
    # prompt (bfloat16 on both paths: printed, not held)
    first = prefill(params, prompt).argmax(-1)
    first_agree = (first == out[:, P]).float().mean().item()
    decode = make_decode_step(cfg)
    caches = lm.init_caches(cfg, B, P + N, params=params)
    tok = out[:, P:P + 1]
    pos = torch.tensor(P, dtype=torch.int32, device=dev)
    step_ms = wall_ms(lambda: decode(params, tok, caches, pos), runs=5)
    step_busy, step_top = forward_profile(
        lambda: decode(params, tok, caches, pos), runs=3)
    cache_b = sum(t.numel() * t.element_size()
                  for t in _tree_leaves(caches))
    # a step reads every weight but the embedding table (B rows of it),
    # reads the cache and writes its new copy
    step_floor = (weight_b - embed_b + B * cfg.d_model * 2
                  + 2 * cache_b) / HBM_BYTES_PER_S * 1e3
    for name, top in (("prefill", prefill_top), ("decode step", step_top)):
        for ms, n, kname in top:
            detail(f"  21d {name}: {kname}: {ms:.3f} ms in {n} launches")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del caches
    # the same greedy loop through the compiled step beside the eager one
    replay = decode_replay(cfg, params, prompt, N)
    for ms, n, kname in replay.pop("top")[:8]:
        detail(f"  21d replayed step: {kname}: {ms:.3f} ms in {n} launches")
    replay_held(f"qwen3_8b b{B}", replay)
    del replay["gaps"], replay["eager_gaps"]
    del params
    torch.cuda.empty_cache()
    return dict(weight_gb=weight_b / 1e9, prefill_ms=prefill_ms, replay=replay,
                prefill_floor=prefill_floor, prefill_tflop=prefill_flop / 1e12,
                prefill_busy=prefill_busy, generate_s=generate_s,
                gen_steps=P + N - 1, step_ms=step_ms, step_floor=step_floor,
                step_busy=step_busy, tok_s=B / step_ms * 1e3,
                first_agree=first_agree,
                peak_gb=peak_gb)


def kv_quant_phase(dev) -> tuple:
    """(e): ``quantize_kv`` on the card ``torch.equal`` to the CPU at the
    served Qwen3-8B cache's shape (batch 8, 192 positions, 8 kv heads of
    128), zero rows included."""
    import torch
    from repro_torch.serve.kv_quant import quantize_kv
    x = torch.randn((8, 192, 8, 128),
                    generator=torch.Generator().manual_seed(4)) * 3
    x[0, :5] = 0
    q, s = quantize_kv(x.to(dev))
    q_ref, s_ref = quantize_kv(x)
    same = torch.equal(q.cpu(), q_ref) and torch.equal(s.cpu(), s_ref)
    check(same, "quantize_kv on the card differs from the CPU")
    return tuple(x.shape), same


def lm_phase(dev) -> dict:
    """Phase 21: (a)-(e) above, with (f) the six kernel-launch counters
    unchanged across the whole phase (the LM path is plain PyTorch)."""
    import torch
    before = _launch_counts()
    t0 = time.perf_counter()
    out = dict(reduced=lm_reduced(dev), depth2=qwen_depth2(dev))
    out["full"] = qwen_full_f32(dev)
    out["serve"] = qwen_serve(dev)
    out["kv_shape"], out["kv_equal"] = kv_quant_phase(dev)
    launched = {k: v - before[k] for k, v in _launch_counts().items()}
    check(not any(launched.values()),
          f"the LM path launched kernels of repro_torch.kernels: {launched}")
    # both thresholds held in float32 compute; in bfloat16 compute the
    # correlation only: 152k random-init logits leave near-ties that
    # bfloat16 rounding flips (agreement 0.9531 on an H100, one flip
    # above 0.95; printed)
    full = out["full"]
    for name in ("bf16", "f32"):
        f = full[name]
        check(f["finite"] and f["corr"] > QWEN_CORR
              and (name == "bf16" or f["agree"] > QWEN_AGREE),
              f"qwen3_8b 36 layers {name} compute: decode vs forward "
              f"agreement {f['agree']:.4f} (> {QWEN_AGREE}), correlation "
              f"{f['corr']:.5f} (> {QWEN_CORR})")
    out["launched"] = launched
    out["s"] = time.perf_counter() - t0
    return out


def lm_line(lmp: dict, card: str) -> str:
    """Phase 21's line on standard output."""
    sv, full = lmp["serve"], lmp["full"]
    busy = (lambda b, ms: "not measured" if b is None
            else f"{b:.3f} ms busy, idle {1 - b / ms:.1%}")
    return ("[21 LM serving] (a) ten archs at reduced() + mixtral ring buffer "
            f"(window {RING['window']}, {RING['steps']} steps), card vs CPU "
            "float32, max rel to max|logit| (forward/encode/decode): "
            + ", ".join(f"{a} " + "/".join(f"{v:.1e}" for v in e.values())
                        for a, e in lmp["reduced"].items())
            + f" (limit {LM_TOL}); (b) qwen3_8b full width depth 2 float32 b"
            f"{QWEN_DEPTH2['batch']}x{QWEN_DEPTH2['seq']} forward card vs CPU "
            f"{lmp['depth2']:.2e}; (c) qwen3_8b 36 layers, float32 params "
            f"{full['gb']:.1f} GB, {QWEN_TEACHER['steps']} teacher-forced "
            "decode steps vs forward: " + ", ".join(
                f"{n} compute agreement {full[n]['agree']:.4f} correlation "
                f"{full[n]['corr']:.6f}" for n in ("bf16", "f32"))
            + f" (held > {QWEN_AGREE} in f32 / > {QWEN_CORR} in both); "
            "(d) bf16 params "
            f"{sv['weight_gb']:.2f} GB: prefill b1x{QWEN_SERVE['prefill']} "
            f"{sv['prefill_ms']:.2f} ms (floor {sv['prefill_floor']:.2f} ms = "
            f"{sv['prefill_tflop']:.1f} TFLOP / bf16 peak; "
            f"{busy(sv['prefill_busy'], sv['prefill_ms'])}), decode step b"
            f"{QWEN_SERVE['batch']} {sv['step_ms']:.3f} ms (floor "
            f"{sv['step_floor']:.3f} ms = bytes / HBM; "
            f"{busy(sv['step_busy'], sv['step_ms'])}) = "
            f"{sv['tok_s']:.1f} tok/s; compiled: "
            + replay_text(sv["replay"], sv["step_ms"], sv["step_floor"])
            + "; greedy_generate "
            f"b{QWEN_SERVE['batch']} prompt {QWEN_SERVE['prompt']} + {QWEN_SERVE['new']} new: "
            f"{sv['generate_s']:.2f} s for {sv['gen_steps']} steps, first "
            f"token = prefill argmax on {sv['first_agree']:.3f} of rows; peak "
            f"{sv['peak_gb']:.1f} GB (host clock + synchronize, median of 5); "
            f"(e) quantize_kv {lmp['kv_shape']} torch.equal to the CPU "
            f"{lmp['kv_equal']}; (f) kernel launches from the LM path "
            f"{lmp['launched']}; phase {lmp['s']:.1f} s | {card}")


# ---------------------------------------------------------------------------
# phase 22: the LM training path (repro_torch.train, data, launch.train)
# ---------------------------------------------------------------------------

# card against CPU in float32 compute: the loss relative, each gradient
# leaf against that leaf's max |grad| (the CPU tests' tolerances against
# JAX); bfloat16 compute by the gradients' correlation, as phase 21 holds
# bfloat16 logits
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_BF16_CORR = 1e-5, 1e-4, 0.99
REMAT_TOL = 1e-6        # remat against no remat on the card, of max |grad|
TRAIN_DEPTH2 = dict(batch=1, seq=256)                       # (b)
# (c): one device's share of configs/base.py's train_4k shape (4096
# tokens, global batch 256 over a 16x16 mesh), with launch.train's seed
# and learning rate
TRAIN_FULL = dict(batch=1, seq=4096, steps=8, timed=5, seed=11, lr=1e-3)
TRAIN_CLI = dict(first=20, total=30, every=10)             # (d)
# (a): steps of each arch through compile_train_step beside the eager step
TRAIN_REPLAY = dict(batch=2, seq=16, steps=3)
# (c), 24 (d): the eager step's recorded figures on this card (PERF.md
# §5: InternLM2-1.8B's step and peak, train_lm's step), printed beside the
# compiled step's
EAGER_TRAIN = dict(full_ms=806.7, full_gb=61.0, example_ms=67.9)
# (d): the resumed run's final parameters against a fresh run's, relative
# to max |param|
TRAIN_RESUME_TOL = 1e-4
# GEMM kernels by name (cuBLAS / cuBLASLt / CUTLASS), the rest being the
# elementwise, reduction and copy passes
GEMM_NAMES = ("gemm", "Gemm", "nvjet", "xmma", "cutlass")


def _is_gemm(name: str) -> bool:
    return any(g in name for g in GEMM_NAMES)


def _is_fill(name: str) -> bool:
    """A kernel that writes a constant (``zeros``, ``fill_``) or a memset:
    what indexing layer i of a stacked leaf costs per layer in the
    backward pass."""
    return "FillFunctor" in name or "Memset" in name


def f32_value_and_grad(cfg, params, batch, remat: bool = False):
    """The next-token cross entropy in float32 compute and its gradient
    per leaf path (``torch.autograd``; zeros for an unread leaf)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.train.step import cross_entropy
    from repro_torch.tree import tree_from_items, tree_items
    leaves = {k: v.detach().requires_grad_() for k, v in tree_items(params)}
    logits = lm.forward(tree_from_items(params, leaves), cfg,
                        batch["tokens"], encoder_input=batch.get("frames"),
                        compute_dtype=torch.float32, remat=remat)
    loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                         cfg.vocab_size)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def _grad_corr(got: dict, want: dict) -> float:
    """Correlation of two gradient trees, leaf sums in float64."""
    tot = [0.0] * 5
    n = 0
    for k, w in want.items():
        x = got[k].double()
        y = w.to(x.device).double()
        tot = [t + s.item() for t, s in zip(tot, (
            x.sum(), y.sum(), (x * x).sum(), (y * y).sum(), (x * y).sum()))]
        n += x.numel()
    sx, sy, sxx, syy, sxy = tot
    return (sxy - sx * sy / n) / math.sqrt((sxx - sx * sx / n)
                                           * (syy - sy * sy / n))


def _tree_gap(got, want) -> float:
    """Largest leaf gap over that leaf's max |value| (0 where every leaf
    is equal) of two trees (nested, or flat dicts keyed by path), on
    ``got``'s device one leaf at a time: ``want`` may be a copy on the
    host."""
    import torch
    from repro_torch.tree import tree_items
    g_items, w_items = tree_items(got), tree_items(want)
    check([k for k, _ in g_items] == [k for k, _ in w_items],
          "two trees of different paths compared")
    worst = 0.0
    for (k, g), (_, w) in zip(g_items, w_items):
        w = w.to(g.device)
        if torch.equal(g, w):
            continue
        gap = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        worst = max(worst, gap / scale if scale else math.inf)
    return worst


def _run_gap(a: dict, b: dict) -> float:
    """Two training runs' gap: final state and every step's metrics."""
    return max([_tree_gap(a["state"], b["state"])]
               + [_tree_gap(x, y) for x, y in zip(a["metrics"],
                                                   b["metrics"])])


def _train_run(step, params, batches) -> dict:
    """``step`` over ``batches`` from ``params`` and a fresh optimizer
    state: each step's metrics and the final state."""
    from repro_torch.train.optimizer import init_opt_state
    p, o, ms = params, init_opt_state(params), []
    for b in batches:
        p, o, m = step(p, o, b)
        ms.append(m)
    return dict(state=dict(params=p, opt=o), metrics=ms)


def train_replay(cfg, params, batches, microbatches: int = 1) -> dict:
    """``compile_train_step`` over ``batches`` beside the eager
    ``make_train_step`` from the same state (bfloat16 compute, remat):
    the replayed run's gap to the eager run and, only where it is not 0,
    a second eager run's (the eager step's own repeatability), the keys
    captured and the capture seconds."""
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import compile_train_step, make_train_step
    ocfg = OptimizerConfig(lr=TRAIN_FULL["lr"], warmup_steps=2)
    eager = make_train_step(cfg, ocfg, microbatches)
    compiled = compile_train_step(cfg, ocfg, microbatches)
    first = _train_run(eager, params, batches)
    replayed = _train_run(compiled, params, batches)
    (exe,) = compiled.executables.values()
    gap = _run_gap(replayed, first)
    # the eager step's own repeatability, needed where the replay differs
    eager_gap = (_run_gap(_train_run(eager, params, batches), first)
                 if gap else 0.0)
    return dict(gap=gap, eager_gap=eager_gap,
                keys=len(compiled.executables), capture_s=exe.capture_s)


def train_replay_held(name: str, r: dict) -> None:
    """Fails unless the replayed run equals the eager one, or, where two
    eager runs differ, is within ``REPLAY_GAP_FACTOR`` times their gap;
    one key captured."""
    if r["eager_gap"] == 0:
        check(r["gap"] == 0, f"{name}: replayed train step differs from "
              f"the eager step by {r['gap']:.2e} of a leaf's max")
    else:
        check(r["gap"] <= REPLAY_GAP_FACTOR * r["eager_gap"],
              f"{name}: replayed train step vs eager {r['gap']:.2e} over "
              f"{REPLAY_GAP_FACTOR} x eager vs eager {r['eager_gap']:.2e}")
    check(r["keys"] == 1, f"{name}: {r['keys']} keys captured, expected 1")


def _replay_text(r: dict) -> str:
    return ("torch.equal" if r["gap"] == 0 else
            f"{r['gap']:.1e} (eager vs eager {r['eager_gap']:.1e})")


def train_reduced(dev) -> dict:
    """(a): every arch at ``reduced()``, float32 weights, batch 2 x 16 on
    the card against the CPU: float32-compute loss and gradients, and one
    ``make_train_step`` step (bfloat16 compute, remat on)."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import lm
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import make_grad_fn, make_train_step
    from repro_torch.tree import tree_items
    out = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_config(arch).reduced()
        gen = torch.Generator().manual_seed(22 + i)
        params = lm.init_params(cfg, gen, device="cpu")
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=gen, dtype=torch.int32)}
        if cfg.is_encdec:
            batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                          generator=gen)
        params_d = _tree(lambda t: t.to(dev), params)
        batch_d = _tree(lambda t: t.to(dev), batch)
        loss_c, grads_c = f32_value_and_grad(cfg, params, batch)
        loss_d, grads_d = f32_value_and_grad(cfg, params_d, batch_d)
        loss_rel = abs(loss_d.item() / loss_c.item() - 1)
        grad_gap = _tree_gap(grads_d, grads_c)
        step = make_train_step(cfg)
        _, st_c, m_c = step(params, init_opt_state(params), batch)
        _, st_d, m_d = step(params_d, init_opt_state(params_d), batch_d)
        corr = _grad_corr(dict(tree_items(make_grad_fn(cfg)(
            params_d, batch_d)[1])), dict(tree_items(make_grad_fn(cfg)(
                params, batch)[1])))
        gen_d = torch.Generator(dev).manual_seed(22 + i)
        batches = [_train_batch(cfg, gen_d, TRAIN_REPLAY["batch"])
                   for _ in range(TRAIN_REPLAY["steps"])]
        replay = train_replay(cfg, params_d, batches)
        train_replay_held(f"22a {arch}", replay)
        r = dict(loss_rel=loss_rel, grad_gap=grad_gap, corr=corr,
                 loss=(m_d["loss"].item(), m_c["loss"].item()),
                 grad_norm=(m_d["grad_norm"].item(),
                            m_c["grad_norm"].item()), replay=replay)
        detail(f"  22a {arch}: {TRAIN_REPLAY['steps']} compiled steps vs "
               f"eager: {replay['gap']:.2e}, eager vs eager "
               f"{replay['eager_gap']:.2e}, capture "
               f"{replay['capture_s']:.3f} s")
        detail(f"  22a {arch}: f32 loss {loss_d.item():.6f} (CPU "
               f"{loss_c.item():.6f}, rel {loss_rel:.1e}), worst gradient "
               f"leaf {grad_gap:.1e} of its max; bf16 step loss "
               f"{r['loss'][0]:.5f}/{r['loss'][1]:.5f} grad_norm "
               f"{r['grad_norm'][0]:.5f}/{r['grad_norm'][1]:.5f} (card/CPU), "
               f"gradient correlation {corr:.6f}")
        check(math.isfinite(loss_d.item()) and loss_rel <= TRAIN_LOSS_TOL
              and grad_gap <= TRAIN_GRAD_TOL,
              f"{arch} float32 loss / gradients card vs CPU: loss rel "
              f"{loss_rel:.2e} (limit {TRAIN_LOSS_TOL}), gradient "
              f"{grad_gap:.2e} (limit {TRAIN_GRAD_TOL})")
        check(corr >= TRAIN_BF16_CORR and int(st_d["step"]) == 1
              and math.isfinite(r["loss"][0]),
              f"{arch} bf16 train step card vs CPU: gradient correlation "
              f"{corr:.5f} (limit {TRAIN_BF16_CORR})")
        out[arch] = r
    return out


def train_micro(dev) -> dict:
    """(a)'s case with ``microbatches=2``: InternLM2 at ``reduced()``, the
    two microbatches unrolled into the captured step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("internlm2_1_8b").reduced()
    gen = torch.Generator(dev).manual_seed(21)
    params = lm.init_params(cfg, gen, device=dev)
    batches = [_train_batch(cfg, gen, TRAIN_REPLAY["batch"])
               for _ in range(TRAIN_REPLAY["steps"])]
    r = train_replay(cfg, params, batches, 2)
    train_replay_held("22a internlm2_1_8b microbatches 2", r)
    return r


def _train_batch(cfg, gen, batch: int) -> dict:
    """A random batch of ``TRAIN_REPLAY['seq']`` tokens (and frames for
    Whisper) on ``gen``'s device."""
    import torch
    out = {"tokens": torch.randint(0, cfg.vocab_size,
                                   (batch, TRAIN_REPLAY["seq"]),
                                   generator=gen, device=gen.device,
                                   dtype=torch.int32)}
    if cfg.is_encdec:
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                    generator=gen, device=gen.device)
    return out


def train_depth2(dev) -> dict:
    """(b): InternLM2-1.8B at full width, depth 2, float32: loss and
    gradients on the card against the CPU at b1 x 256; remat against no
    remat on the card; microbatches=2 against 1 at b2 (bfloat16)."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train.step import make_grad_fn
    from repro_torch.tree import tree_items
    cfg = _full("internlm2_1_8b", 2)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    b, s = TRAIN_DEPTH2["batch"], TRAIN_DEPTH2["seq"]
    batch = TokenPipeline(cfg.vocab_size, b, s, seed=11,
                          device=dev).batch_at(0)
    loss_d, grads_d = f32_value_and_grad(cfg, params, batch)
    loss_r, grads_r = f32_value_and_grad(cfg, params, batch, remat=True)
    remat_gap = _tree_gap(grads_r, grads_d)
    remat_equal = torch.equal(loss_r, loss_d) and all(
        torch.equal(grads_r[k], grads_d[k]) for k in grads_d)
    del grads_r
    grads_d = _tree(lambda t: t.cpu(), grads_d)
    params_c = _tree(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    loss_c, grads_c = f32_value_and_grad(
        cfg, params_c, _tree(lambda t: t.cpu(), batch))
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss_d.item() / loss_c.item() - 1)
    grad_gap = _tree_gap(grads_d, grads_c)
    del grads_c, grads_d, params_c
    batch2 = TokenPipeline(cfg.vocab_size, 2, s, seed=11,
                           device=dev).batch_at(0)
    l1, g1 = make_grad_fn(cfg, 1, remat=False)(params, batch2)
    l2, g2 = make_grad_fn(cfg, 2, remat=False)(params, batch2)
    mb_corr = _grad_corr(dict(tree_items(g2)), dict(tree_items(g1)))
    mb_loss_rel = abs(l2.item() / l1.item() - 1)
    check(loss_rel <= TRAIN_LOSS_TOL and grad_gap <= TRAIN_GRAD_TOL,
          f"internlm2 depth 2 float32 card vs CPU: loss rel {loss_rel:.2e} "
          f"(limit {TRAIN_LOSS_TOL}), gradient {grad_gap:.2e} (limit "
          f"{TRAIN_GRAD_TOL})")
    check(remat_gap <= REMAT_TOL,
          f"internlm2 depth 2 remat vs no remat: {remat_gap:.2e} (limit "
          f"{REMAT_TOL})")
    check(mb_corr >= TRAIN_BF16_CORR,
          f"internlm2 depth 2 microbatches 2 vs 1: gradient correlation "
          f"{mb_corr:.5f} (limit {TRAIN_BF16_CORR})")
    del params, g1, g2
    torch.cuda.empty_cache()
    return dict(loss=loss_d.item(), loss_rel=loss_rel, grad_gap=grad_gap,
                cpu_s=cpu_s, remat_gap=remat_gap, remat_equal=remat_equal,
                mb_corr=mb_corr, mb_loss_rel=mb_loss_rel)


def train_step_flop(cfg, params, tokens: int, seq: int) -> float:
    """Operations of one remat train step of a dense model, worked out
    from the code: each layer matrix and the head in a product per token
    (forward, and twice that backward), the layers' products once more in
    remat's recompute, and ``mha_chunked``'s scores and P.V over all
    ``seq`` keys of every row (it computes each query chunk against every
    key, masked after) in the forward, the recompute and twice backward."""
    from repro_torch.tree import tree_items
    layer_mat = sum(t.numel() for k, t in tree_items(params["blocks"])
                    if t.ndim >= 3)
    head = params.get("lm_head", params["embed"]).numel()
    attn = cfg.n_layers * 4 * cfg.n_heads * cfg.resolved_head_dim \
        * seq * tokens
    return tokens * (6 * (layer_mat + head) + 2 * layer_mat) + 4 * attn


def _full_loop(step, state: dict, pipe, tag: str) -> dict:
    """``TRAIN_FULL['steps']`` steps of ``step`` on ``state`` ({params,
    opt}: the loop replaces both, so no earlier tree outlives its step)
    from ``pipe``'s first batches: each step's metrics, loss, grad_norm
    and time (host clock + synchronize)."""
    import torch
    out = dict(losses=[], norms=[], times=[], metrics=[])
    for i in range(TRAIN_FULL["steps"]):
        batch = pipe.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state["params"], state["opt"], m = step(state["params"],
                                                state["opt"], batch)
        torch.cuda.synchronize()
        out["times"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append(m)
        out["losses"].append(m["loss"].item())
        out["norms"].append(m["grad_norm"].item())
        detail(f"  22c {tag} step {i + 1}: loss {out['losses'][-1]:.5f} "
               f"grad_norm {out['norms'][-1]:.5f} {out['times'][-1]:.1f} ms")
    out["step_ms"] = statistics.median(out["times"][-TRAIN_FULL["timed"]:])
    return out


def train_full(dev) -> dict:
    """(c): InternLM2-1.8B at full width and its 24 layers, float32
    parameters with AdamW state, ``TRAIN_FULL['steps']`` remat steps at
    b1 x 4096 from ``TokenPipeline(seed=11)``, timed and profiled, through
    the eager ``make_train_step`` and then, from the same state, through
    ``compile_train_step`` (the eager run's final state kept on the host
    meanwhile: the card holds no two runs' trees at once), held as (a)
    holds it (a second eager run only where the replayed one differs)."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.train.step import compile_train_step, make_train_step
    from repro_torch.tree import tree_items, tree_leaves
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    cfg = _full("internlm2_1_8b")

    def fresh() -> dict:
        p = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
        return dict(params=p, opt=init_opt_state(p))
    state = fresh()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    sums0 = {k: t.double().sum().item()
             for k, t in tree_items(state["params"])}
    b, s = TRAIN_FULL["batch"], TRAIN_FULL["seq"]
    pipe = TokenPipeline(cfg.vocab_size, b, s, seed=TRAIN_FULL["seed"],
                         device=dev)
    ocfg = OptimizerConfig(lr=TRAIN_FULL["lr"])
    step = make_train_step(cfg, ocfg, remat=True)
    run = _full_loop(step, state, pipe, "eager")
    params, opt = state["params"], state["opt"]
    losses, norms = run["losses"], run["norms"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = [k for k, t in tree_items(params)
             if t.double().sum().item() != sums0[k]]
    check(all(math.isfinite(x) for x in losses + norms)
          and int(opt["step"]) == TRAIN_FULL["steps"]
          and len(moved) == len(sums0),
          f"internlm2 full training: losses {losses}, step "
          f"{int(opt['step'])}, {len(moved)} of {len(sums0)} leaves moved")
    step_ms = run["step_ms"]
    flop = train_step_flop(cfg, params, b * s, s)
    state_b = 4 * n_params
    opt_bytes = 7 * state_b      # read p, g, m, v; write p, m, v
    floor = (flop / BF16_OPS_PER_S + opt_bytes / HBM_BYTES_PER_S) * 1e3
    batch = pipe.batch_at(TRAIN_FULL["steps"])
    busy, kernels = forward_profile(lambda: step(params, opt, batch),
                                    runs=1, top=None, name_chars=400)
    # the optimizer alone (the parameters stand in for the gradients: its
    # time does not depend on their values)
    opt_ms = wall_ms(lambda: adamw_update(ocfg, params, params, opt),
                     runs=3)
    # one layer's attention core as remat runs it: a forward, then the
    # recomputed forward and its backward
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    qkv = [torch.randn((b, s, h, hd), device=dev, dtype=torch.bfloat16,
                       requires_grad=True) for _ in range(3)]
    g_out = torch.randn((b, s, h, hd), device=dev, dtype=torch.bfloat16)

    def attn_layer():
        with torch.no_grad():
            L.mha_chunked(*qkv, causal=True, window=cfg.sliding_window)
        out = L.mha_chunked(*qkv, causal=True, window=cfg.sliding_window)
        torch.autograd.grad(out, qkv, g_out)
    _, attn_kernels = forward_profile(attn_layer, runs=1, top=None)
    eager = dict(state=_tree(lambda t: t.cpu(), state),
                 metrics=run["metrics"])
    del state, params, opt, qkv
    torch.cuda.empty_cache()
    out = dict(losses=losses, norms=norms, step_ms=step_ms,
               tok_s=b * s / step_ms * 1e3, floor=floor, tflop=flop / 1e12,
               opt_gb=opt_bytes / 1e9, params_b=n_params / 1e9,
               peak_gb=peak_gb, held_gb=held_gb, busy=busy, opt_ms=opt_ms,
               opt_floor=opt_bytes / HBM_BYTES_PER_S * 1e3,
               layers=cfg.n_layers)
    if busy is not None:
        gemm = sum(ms for ms, _, name in kernels if _is_gemm(name))
        attn_elem = cfg.n_layers * sum(ms for ms, _, name in attn_kernels
                                       if not _is_gemm(name))
        out.update(gemm_ms=gemm, attn_elem_ms=attn_elem, top=kernels[:3],
                   launches=sum(n for _, n, _ in kernels),
                   fills=sum(n for _, n, name in kernels if _is_fill(name)))
        for ms, n, name in kernels[:10]:
            detail(f"  22c step profile: {name[:100]}: {ms:.3f} ms in {n} "
                   "launches")
    out["compiled"] = _full_compiled(cfg, fresh, pipe, ocfg, eager)
    out["compiled"]["tok_s"] = b * s / out["compiled"]["step_ms"] * 1e3
    return out


def _full_compiled(cfg, fresh, pipe, ocfg, eager: dict) -> dict:
    """(c)'s compiled run: ``compile_train_step`` from ``fresh()``'s state
    over the eager run's batches, its gap to the eager run (``eager``:
    the final state on the host and each step's metrics), the replayed
    step's time, profile, capture seconds and peak memory."""
    import torch
    from repro_torch.train.step import compile_train_step, make_train_step
    torch.cuda.reset_peak_memory_stats()
    compiled = compile_train_step(cfg, ocfg, remat=True)
    state = fresh()
    run = _full_loop(compiled, state, pipe, "compiled")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (exe,) = compiled.executables.values()
    got = dict(state=state, metrics=run["metrics"])
    gap = _run_gap(got, eager)
    check(all(math.isfinite(x) for x in run["losses"] + run["norms"])
          and int(got["state"]["opt"]["step"]) == TRAIN_FULL["steps"],
          f"internlm2 full compiled training: losses {run['losses']}")
    p, o = got["state"]["params"], got["state"]["opt"]
    batch = pipe.batch_at(TRAIN_FULL["steps"])
    busy, kernels = forward_profile(lambda: compiled(p, o, batch), runs=1,
                                    top=None)
    out = dict(run, gap=gap, eager_gap=0.0, keys=len(compiled.executables),
               capture_s=exe.capture_s, peak_gb=peak_gb, busy=busy,
               launches=sum(n for _, n, _ in kernels))
    del got, state, p, o, exe, compiled
    torch.cuda.empty_cache()
    if gap:
        # the eager step's own repeatability: a second eager run
        state = fresh()
        again = _full_loop(make_train_step(cfg, ocfg, remat=True), state,
                           pipe, "eager again")
        out["eager_gap"] = _run_gap(dict(state=state,
                                         metrics=again["metrics"]), eager)
        del again, state
        torch.cuda.empty_cache()
    train_replay_held("22c internlm2_1_8b full size", out)
    return out


def train_cli(dev) -> dict:
    """(d): ``python -m repro_torch.launch.train --reduced`` for
    ``TRAIN_CLI['first']`` steps, then relaunched to ``['total']`` in the
    same directory (it resumes), against a fresh ``['total']``-step run
    through ``main(argv)`` in this process."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    from repro_torch.launch import train as launch_train
    args = ["--arch", "internlm2_1_8b", "--reduced", "--ckpt-every",
            str(TRAIN_CLI["every"])]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        resumed, fresh = os.path.join(tmp, "resumed"), os.path.join(tmp,
                                                                   "fresh")
        outs = []
        t0 = time.perf_counter()
        for steps in (TRAIN_CLI["first"], TRAIN_CLI["total"]):
            p = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", *args,
                 "--steps", str(steps), "--ckpt-dir", resumed], env=env,
                capture_output=True, text=True, timeout=600)
            check(p.returncode == 0, f"launch.train --steps {steps} exited "
                  f"{p.returncode}: {p.stderr[-2000:]}")
            outs.append(p.stdout)
        cli_s = time.perf_counter() - t0
        check(f"[resume] step {TRAIN_CLI['first']}" in outs[1]
              and "training complete" in outs[1],
              f"the relaunch did not resume: {outs[1][-500:]}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = launch_train.main([*args, "--steps", str(TRAIN_CLI["total"]),
                                   "--ckpt-dir", fresh])
        for ln in outs[1].splitlines() + buf.getvalue().splitlines():
            detail(f"  22d {ln}")
        captures = [_capture_line(o) for o in outs]
        check(captures == [
            f"train step: 1 CUDA graph capture(s) over {n} steps"
            for n in (TRAIN_CLI["first"],
                      TRAIN_CLI["total"] - TRAIN_CLI["first"])]
              and r["captures"] == 1,
              f"launch.train captures: {captures}, fresh run {r}")
        gap, equal = 0.0, True
        for name in ("params", "opt_state"):
            path = f"step_{TRAIN_CLI['total']}/{name}.npz"
            with np.load(os.path.join(resumed, path)) as a, \
                    np.load(os.path.join(fresh, path)) as f:
                for k in f.files:
                    equal &= bool(np.array_equal(a[k], f[k]))
                    if name == "params":
                        scale = float(np.abs(f[k]).max())
                        gap = max(gap, float(np.abs(a[k] - f[k]).max())
                                  / scale if scale else 0.0)
    check(gap <= TRAIN_RESUME_TOL,
          f"resumed launch.train vs a fresh run: {gap:.2e} of max |param| "
          f"(limit {TRAIN_RESUME_TOL})")
    return dict(gap=gap, equal=equal, cli_s=cli_s, captures=captures)


def _capture_line(text: str) -> str | None:
    """The ``train step: ...`` line an entry point prints at its end."""
    return next((ln for ln in text.splitlines()
                 if ln.startswith("train step: ")), None)


def train_phase(dev) -> dict:
    """Phase 22: (a)-(d) above, with (e) the six kernel-launch counters
    unchanged across it (the training path is plain PyTorch)."""
    before = _launch_counts()
    t0 = time.perf_counter()
    out = dict(reduced=train_reduced(dev), micro=train_micro(dev),
               depth2=train_depth2(dev), full=train_full(dev),
               cli=train_cli(dev))
    launched = {k: v - before[k] for k, v in _launch_counts().items()}
    check(not any(launched.values()),
          f"the training path launched kernels of repro_torch.kernels: "
          f"{launched}")
    out["launched"] = launched
    out["s"] = time.perf_counter() - t0
    return out


def train_line(tp: dict, card: str) -> str:
    """Phase 22's line on standard output."""
    d2, fu, cli = tp["depth2"], tp["full"], tp["cli"]
    red, co = tp["reduced"], tp["full"]["compiled"]
    cbusy = ("busy not measured" if co["busy"] is None else
             f"busy {co['busy']:.1f} ms, idle "
             f"{1 - co['busy'] / co['step_ms']:.1%}, {co['launches']} "
             "kernels")
    if fu["busy"] is None:
        prof = "device busy not measured (no profiler device events)"
    else:
        prof = (f"busy {fu['busy']:.1f} ms, idle "
                f"{1 - fu['busy'] / fu['step_ms']:.1%}, {fu['launches']} "
                f"launches ({fu['fills']} fill), GEMMs {fu['gemm_ms']:.1f} "
                f"ms ({fu['gemm_ms'] / fu['busy']:.1%} of busy), attention's "
                f"elementwise passes {fu['attn_elem_ms']:.1f} ms "
                f"({fu['attn_elem_ms'] / fu['busy']:.1%} of busy); largest "
                "kernels " + ", ".join(
                    f"{name.removeprefix('void at::native::')[:64]} "
                    f"{ms:.1f} ms in {n}" for ms, n, name in fu["top"]))
    return ("[22 LM training] (a) ten archs at reduced(), b2x16, card vs "
            "CPU: float32 loss rel / worst gradient leaf / bf16 step "
            "gradient correlation: " + ", ".join(
                f"{a} {r['loss_rel']:.0e}/{r['grad_gap']:.0e}/"
                f"{r['corr']:.5f}" for a, r in red.items())
            + f" (limits {TRAIN_LOSS_TOL}/{TRAIN_GRAD_TOL}/"
            f"{TRAIN_BF16_CORR}); compile_train_step vs eager over "
            f"{TRAIN_REPLAY['steps']} steps (params, m, v, step, metrics): "
            + ", ".join(f"{a} {_replay_text(r['replay'])}"
                        for a, r in red.items())
            + f", internlm2 microbatches 2 {_replay_text(tp['micro'])}; "
            "capture " + "/".join(f"{r['replay']['capture_s']:.2f}"
                                  for r in red.values())
            + " s; (b) internlm2_1_8b full width depth 2 "
            f"float32 b{TRAIN_DEPTH2['batch']}x{TRAIN_DEPTH2['seq']}: card vs "
            f"CPU loss rel {d2['loss_rel']:.1e}, gradient "
            f"{d2['grad_gap']:.1e}; remat vs none {d2['remat_gap']:.1e} "
            f"(torch.equal {d2['remat_equal']}); microbatches 2 vs 1 at b2 "
            f"bf16: gradient correlation {d2['mb_corr']:.6f}, loss rel "
            f"{d2['mb_loss_rel']:.1e}; (c) internlm2_1_8b {fu['layers']} "
            "layers, "
            f"{fu['params_b']:.3f} B float32 params + AdamW, remat, b"
            f"{TRAIN_FULL['batch']}x{TRAIN_FULL['seq']}, "
            f"{TRAIN_FULL['steps']} steps: loss "
            + "/".join(f"{x:.4f}" for x in fu["losses"])
            + ", grad_norm " + "/".join(f"{x:.3f}" for x in fu["norms"])
            + f"; step {fu['step_ms']:.1f} ms (host clock + synchronize, "
            f"median of the last {TRAIN_FULL['timed']}) = "
            f"{fu['tok_s']:.0f} tokens/s; floor {fu['floor']:.1f} ms "
            f"({fu['tflop']:.1f} TFLOP at the bf16 peak + the optimizer's "
            f"{fu['opt_gb']:.1f} GB over HBM); {prof}; optimizer alone "
            f"{fu['opt_ms']:.1f} ms ({fu['opt_ms'] / fu['step_ms']:.1%} of "
            f"the step; floor {fu['opt_floor']:.1f} ms); peak "
            f"{fu['peak_gb']:.1f} GB ({fu['held_gb']:.1f} GB held before); "
            f"compile_train_step from the same state: loss "
            + "/".join(f"{x:.4f}" for x in co["losses"])
            + f", vs eager {_replay_text(co)}; replayed step "
            f"{co['step_ms']:.1f} ms ({cbusy}) = {co['tok_s']:.0f} tokens/s, "
            f"{co['step_ms'] / fu['floor']:.1f}x the floor, beside eager "
            f"{fu['step_ms']:.1f} ms here and {EAGER_TRAIN['full_ms']} ms "
            f"recorded; capture {co['capture_s']:.2f} s (at step 2: the "
            f"first call of a key is the eager step); peak "
            f"{co['peak_gb']:.1f} GB (eager {fu['peak_gb']:.1f} here, "
            f"{EAGER_TRAIN['full_gb']} recorded); "
            f"(d) launch.train --reduced {TRAIN_CLI['first']} steps + resume "
            f"to {TRAIN_CLI['total']} ({cli['cli_s']:.1f} s) vs a fresh "
            f"{TRAIN_CLI['total']}-step run: {cli['gap']:.1e} of max |param| "
            f"(limit {TRAIN_RESUME_TOL}), torch.equal {cli['equal']}, "
            + "; ".join(cli["captures"]) + "; (e) "
            f"kernel launches from the training path {tp['launched']}; phase "
            f"{tp['s']:.1f} s | {card}")


# ---------------------------------------------------------------------------
# phase 23: the LM framework's sharding (repro_torch.sharding, the
# sequence-sharded decode) and the mesh dry-run (repro_torch.launch.{mesh,
# cost,dryrun,roofline})
# ---------------------------------------------------------------------------

SHARD_PREFILL = dict(batch=2, seq=64)       # (a): phase 21 (b)'s cell
SHARD_DECODE = dict(batch=2, steps=16, cache=64)
SHARD_SEQ_TOL = 2e-4    # seq-sharded decode vs plain, of max |logit|
SHARD_PREFILL_TOL = 1e-4
# (b): the three full-size dry-run cells, traced concurrently
DRYRUN_CELLS = (("train_4k", False), ("decode_32k", False),
                ("train_4k", True))
DRYRUN_TIMEOUT = 600
# (c): the hand counts of phases 21 (d) and 22 (c), and their measured times
COUNT_TOL = 0.05
MEASURED_MS = dict(train=806.7, prefill=455.14)    # PERF.md §5


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _full_tensors(tree):
    return _tree(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                 else t, tree)


def shard_mesh_phase(dev) -> dict:
    """(a): a 1-rank NCCL group and ``make_local_mesh("cuda")``; Qwen3-8B
    at full width, depth 2, as DTensors under the active rules: the
    bfloat16 prefill against the plain path, 16 float32 decode steps
    through the sequence-sharded branch against the plain decode;
    InternLM2-1.8B at depth 2, b1 x 256: the float32 loss and gradients
    and one bfloat16 ``make_train_step`` step against the plain path."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.rules import ShardingRules, distribute
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import make_train_step
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    out = {}
    try:
        mesh = make_local_mesh("cuda")
        cfg = _full("qwen3_8b", 2)
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
        rules = ShardingRules(cfg, model_size=1, data_size=1)
        rules.mesh = mesh
        dparams = distribute(params, rules.param_specs(params), mesh)
        b, s = SHARD_PREFILL["batch"], SHARD_PREFILL["seq"]
        tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
        dtok = distribute(tokens, rules.tokens_spec(b), mesh)
        prefill = make_prefill_step(cfg)
        want = prefill(params, tokens)
        with shctx.use_rules(rules):
            got = prefill(dparams, dtok).full_tensor()
        out["prefill_equal"] = torch.equal(got, want)
        out["prefill_gap"] = _rel(got, want)
        check(bool(torch.isfinite(got).all())
              and out["prefill_gap"] <= SHARD_PREFILL_TOL,
              f"qwen3_8b depth 2 prefill under the mesh vs plain: "
              f"{out['prefill_gap']:.2e} (limit {SHARD_PREFILL_TOL})")

        f32 = torch.float32
        B, n = SHARD_DECODE["batch"], SHARD_DECODE["steps"]
        caches = lm.init_caches(cfg, B, SHARD_DECODE["cache"], dtype=f32,
                                params=params)
        dcaches = distribute(caches, rules.cache_specs(caches, B), mesh)
        worst, seqsharded = 0.0, True
        for i in range(n):
            tok = tokens[:B, i:i + 1]
            lw, caches = lm.decode_step(params, cfg, tok, caches, i,
                                        compute_dtype=f32)
            with shctx.use_rules(rules):
                lg, dcaches = lm.decode_step(dparams, cfg, dtok[:B, i:i + 1],
                                             dcaches, i, compute_dtype=f32)
            worst = max(worst, _rel(lg.full_tensor(), lw))
            seqsharded &= type(dcaches["kv"]["k"]).__name__ == "DTensor"
        # the first layer's cache is written from the same embedding rows:
        # equal; the second's from activations that carry the first
        # layer's ulps (held to the logits' tolerance, of max |k|, |v|)
        full = _full_tensors(dcaches)
        cache_equal = all(torch.equal(full["kv"][k][0], caches["kv"][k][0])
                          for k in ("k", "v"))
        cache_gap = max(_rel(full["kv"][k], caches["kv"][k])
                        for k in ("k", "v"))
        out.update(decode_gap=worst, cache_equal=cache_equal,
                   cache_gap=cache_gap)
        check(seqsharded and worst <= SHARD_SEQ_TOL and cache_equal
              and cache_gap <= SHARD_SEQ_TOL,
              f"qwen3_8b depth 2 sequence-sharded decode vs plain: "
              f"{worst:.2e} (limit {SHARD_SEQ_TOL}), first layer's cache "
              f"equal {cache_equal}, caches {cache_gap:.2e}")
        del params, dparams, caches, dcaches
        torch.cuda.empty_cache()

        cfg = _full("internlm2_1_8b", 2)
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
        rules = ShardingRules(cfg, model_size=1, data_size=1)
        rules.mesh = mesh
        dparams = distribute(params, rules.param_specs(params), mesh)
        b, s = TRAIN_DEPTH2["batch"], TRAIN_DEPTH2["seq"]
        batch = TokenPipeline(cfg.vocab_size, b, s, seed=11,
                              device=dev).batch_at(0)
        dbatch = {"tokens": distribute(batch["tokens"],
                                       rules.tokens_spec(b), mesh)}
        loss, grads = f32_value_and_grad(cfg, params, batch)
        with shctx.use_rules(rules):
            dloss, dgrads = f32_value_and_grad(cfg, dparams, dbatch)
        out["loss_rel"] = abs(dloss.full_tensor().item() / loss.item() - 1)
        out["grad_gap"] = _tree_gap(_full_tensors(dgrads), grads)
        del grads, dgrads
        step = make_train_step(cfg, remat=True)
        opt = init_opt_state(params)
        new, _, m = step(params, opt, batch)
        with shctx.use_rules(rules):
            dnew, _, dm = step(dparams, init_opt_state(dparams), dbatch)
        dnew = _full_tensors(dnew)
        out["step_loss_equal"] = torch.equal(
            _full_tensors({"l": dm["loss"]})["l"], m["loss"])
        out["step_param_gap"] = max(
            ((dnew[k] - new[k]).abs().max() / new[k].abs().max()).item()
            for k in ("embed", "lm_head"))
        check(out["loss_rel"] <= TRAIN_LOSS_TOL
              and out["grad_gap"] <= TRAIN_GRAD_TOL
              and out["step_param_gap"] <= TRAIN_GRAD_TOL,
              f"internlm2 depth 2 under the mesh vs plain: loss rel "
              f"{out['loss_rel']:.2e} (limit {TRAIN_LOSS_TOL}), gradient "
              f"{out['grad_gap']:.2e} (limit {TRAIN_GRAD_TOL}), step's "
              f"parameters {out['step_param_gap']:.2e}")
        del params, dparams, new, dnew, opt
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def dryrun_phase() -> dict:
    """(b): ``python -m repro_torch.launch.dryrun`` for Qwen3-8B's
    ``DRYRUN_CELLS`` at full size on the fake 256- and 512-rank worlds,
    three processes at once; each cell's JSON line and seconds."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def run(cell):
        shape, multi_pod = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "qwen3_8b", "--shape", shape] + (["--multi-pod"]
                                                if multi_pod else [])
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, env=env, text=True,
                                  capture_output=True,
                                  timeout=DRYRUN_TIMEOUT)
            code, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            code, stdout, stderr = "timeout", e.stdout or "", e.stderr or ""
        return cell, code, stdout, stderr, time.perf_counter() - t0

    cells = []
    with ThreadPoolExecutor(len(DRYRUN_CELLS)) as pool:
        for (shape, multi_pod), code, stdout, stderr, secs in pool.map(
                run, DRYRUN_CELLS):
            lines = [ln for ln in str(stdout).splitlines()
                     if ln.startswith("{")]
            rec = json.loads(lines[-1]) if lines else {}
            detail(f"  23b {shape}{' multi-pod' if multi_pod else ''}: "
                   f"exit {code}, {secs:.1f} s; {str(stderr)[-1500:]}")
            check(code == 0 and rec.get("status") == "ok",
                  f"dry-run qwen3_8b {shape} multi_pod={multi_pod}: exit "
                  f"{code}, {rec or str(stderr)[-800:]}")
            cells.append(dict(rec, seconds=secs))
    return {"cells": cells}


def count_phase() -> dict:
    """(c): ``launch.cost.Counter`` under ``FakeTensorMode`` (no card
    memory) over InternLM2-1.8B's remat train step at b1 x 4096 and
    Qwen3-8B's bfloat16 prefill at b1 x 4096, against the hand counts of
    phases 22 (c) (``train_step_flop``) and 21 (d)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import cost
    from repro_torch.models import lm
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    out = {}
    with FakeTensorMode():
        cfg = _full("internlm2_1_8b")
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
        tokens = torch.zeros((1, 4096), dtype=torch.int32, device="cuda")
        step = make_train_step(cfg, OptimizerConfig(lr=1e-3), remat=True)
        opt = init_opt_state(params)
        t0 = time.perf_counter()
        with cost.Counter() as c:
            c.track((params, opt))
            step(params, opt, {"tokens": tokens})
        hand = train_step_flop(cfg, params, 4096, 4096)
        out["train"] = dict(flops=c.flops, hand=hand, s=time.perf_counter()
                            - t0, roof=c.roofline().as_dict())
        del params, opt

        cfg = _full("qwen3_8b")
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                dtype=torch.bfloat16, device="cuda")
        S = QWEN_SERVE["prefill"]
        mat = sum(t.numel() for t in _tree_leaves(params) if t.ndim >= 2) \
            - params["embed"].numel()
        hand = 2 * S * mat + cfg.n_layers * 4 * cfg.n_heads * S * S \
            * cfg.resolved_head_dim
        t0 = time.perf_counter()
        with cost.Counter() as c:
            c.track(params)
            make_prefill_step(cfg)(params, tokens[:, :S])
        out["prefill"] = dict(flops=c.flops, hand=hand,
                              s=time.perf_counter() - t0,
                              roof=c.roofline().as_dict())
    for name, r in out.items():
        check(abs(r["flops"] / r["hand"] - 1) <= COUNT_TOL,
              f"counted {name} flops {r['flops']:.4e} vs hand count "
              f"{r['hand']:.4e} (limit {COUNT_TOL:.0%})")
    return out


def timed_dryrun() -> tuple[dict, float]:
    """(b) and its seconds, for a background thread (``main`` starts it
    before phase 24: its three processes use only the host's cores)."""
    t0 = time.perf_counter()
    out = dryrun_phase()
    return out, time.perf_counter() - t0


def shard_phase(dev, dryrun=None) -> dict:
    """Phase 23: (a)-(c) above, with the six kernel-launch counters
    unchanged across (a) and (c) (the sharded paths are plain PyTorch).
    ``dryrun``, where given, is the future of a ``timed_dryrun`` started
    earlier; (b) is its result."""
    before = _launch_counts()
    t0 = time.perf_counter()
    out = dict(mesh=shard_mesh_phase(dev))
    out["mesh_s"] = time.perf_counter() - t0
    out["dryrun"], out["dryrun_s"] = (timed_dryrun() if dryrun is None
                                      else dryrun.result())
    out["count"] = count_phase()
    launched = {k: v - before[k] for k, v in _launch_counts().items()}
    check(not any(launched.values()),
          f"the sharded paths launched kernels of repro_torch.kernels: "
          f"{launched}")
    out["launched"] = launched
    out["s"] = time.perf_counter() - t0
    return out


def shard_line(sp: dict, card: str) -> str:
    """Phase 23's line on standard output (the dry-run's roofline terms
    come from data-sheet constants: a model of an H100 cluster)."""
    from repro_torch.launch import roofline
    m, cnt = sp["mesh"], sp["count"]
    for rec in sp["dryrun"]["cells"]:
        log("[23 dry-run] " + json.dumps(
            {k: v for k, v in rec.items() if k != "roofline"}))
    for mp_ in (False, True):
        rows = [r for r in sp["dryrun"]["cells"]
                if r["cell"].endswith("multipod") == mp_]
        for ln in roofline.fmt_table(rows).splitlines():
            log(f"[23 roofline {'multi' if mp_ else 'single'}-pod, "
                f"data-sheet model] {ln}")
    cells = "; ".join(
        f"{r['cell']} {r['status']} trace {r['trace_s']} s (process "
        f"{r['seconds']:.1f} s), peak "
        f"{r['memory']['peak_bytes_per_device'] / 1e9:.2f} GB/device, "
        f"useful {r['useful_flops_ratio']:.3f}, bound "
        f"{r['roofline']['bottleneck']}" for r in sp["dryrun"]["cells"])
    counts = "; ".join(
        f"{name} counted {r['flops'] / 1e12:.2f} TFLOP vs hand "
        f"{r['hand'] / 1e12:.2f} ({r['flops'] / r['hand'] - 1:+.2%}, "
        f"limit {COUNT_TOL:.0%}; {r['s']:.1f} s), data-sheet roofline "
        f"compute {r['roof']['compute_s'] * 1e3:.1f} ms / memory "
        f"{r['roof']['memory_s'] * 1e3:.1f} ms beside the measured "
        f"{MEASURED_MS[name]} ms" for name, r in cnt.items())
    return ("[23 LM sharding] (a) 1-rank NCCL mesh: qwen3_8b depth 2 bf16 "
            f"prefill b{SHARD_PREFILL['batch']}x{SHARD_PREFILL['seq']} vs "
            f"plain {m['prefill_gap']:.2e} (torch.equal "
            f"{m['prefill_equal']}); {SHARD_DECODE['steps']} sequence-"
            f"sharded float32 decode steps vs plain {m['decode_gap']:.2e} "
            f"(limit {SHARD_SEQ_TOL}), first layer's cache torch.equal "
            f"{m['cache_equal']}, both layers' {m['cache_gap']:.1e} of max; "
            "internlm2 depth 2 b"
            f"{TRAIN_DEPTH2['batch']}x{TRAIN_DEPTH2['seq']} float32 loss rel "
            f"{m['loss_rel']:.1e} gradient {m['grad_gap']:.1e}, bf16 step "
            f"loss torch.equal {m['step_loss_equal']} parameters "
            f"{m['step_param_gap']:.1e} ({sp['mesh_s']:.1f} s); (b) "
            f"dry-run {cells} ({sp['dryrun_s']:.1f} s); (c) {counts}; "
            f"kernel launches {sp['launched']}; phase {sp['s']:.1f} s | "
            f"{card}")


# ---------------------------------------------------------------------------
# phase 24: the examples and the entry points on the card
# ---------------------------------------------------------------------------

QUICK_NETS = ("resnet18", "custom", "vit-tiny")    # (a), in this process
XBAR_NETS = ("alexnet", "resnet18")                # (b)
XBAR_BATCH = 8
XBAR_REL = 1e-4          # card against CPU, clean logits (as phase 5)
SERVE_ARCHS = ("internlm2_1_8b", "xlstm_1_3b", "whisper_medium")   # (c)
TIE = 1e-4               # a near-tied greedy step: top-two margin / max|logit|
TRAIN_EX = dict(steps=60, every=20, kill=40)       # (d)
SIGTERM_STEPS = 30       # (e)


def _example(name: str):
    """``examples/<name>.py`` loaded as a module (the examples are
    scripts, not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(mod, argv: list) -> dict:
    """An example's ``main(argv)`` with its printing sent to standard
    error; its ``SystemExit`` (a failed check) fails the phase."""
    import contextlib
    try:
        with contextlib.redirect_stdout(sys.stderr):
            return mod.main(argv)
    except SystemExit as e:
        raise SmokeFailure(f"{mod.__name__} {' '.join(argv)}: {e}") from e


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                PYTHONUNBUFFERED="1")


def _run(argv: list, timeout: int = 300) -> str:
    """A subprocess from the repository root; fails the phase unless it
    exits 0.  Returns its standard output."""
    p = subprocess.run([sys.executable, *argv], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=timeout)
    check(p.returncode == 0, f"{' '.join(argv)} exited {p.returncode}: "
          f"{p.stderr[-2000:]}")
    for ln in p.stdout.splitlines():
        detail(f"  24 {argv[1] if argv[0] == '-m' else argv[0]}: {ln}")
    return p.stdout


def quickstart_phase() -> dict:
    """(a): ``examples/quickstart_torch.py``: AlexNet at batch 2 as a
    subprocess with no ``--device`` (bit-exact twice), then ResNet-18,
    the custom net and vit-tiny through ``main`` here: bit-exact and the
    round trip for the CNNs, vit-tiny's logits and probabilities within
    the example's ``SEQ_REL`` / ``SEQ_PROB_ATOL`` (its round trip
    exact), and one launch of each kernel per stage in ``run``."""
    out = _run(["examples/quickstart_torch.py", "--net", "alexnet",
                "--batch", "2"])
    first = out.splitlines()[0]
    check(first.startswith("device: NVIDIA")
          and out.count("bit-exact=True") == 2,
          f"quickstart alexnet: {first!r}, bit-exact=True "
          f"{out.count('bit-exact=True')} times (want 2)")
    alex_us = float(re.search(r"steady-state (\d+) us", out).group(1))
    quick = _example("quickstart_torch")
    nets, launches = {}, each(0)
    for net in QUICK_NETS:
        r, n = counted(lambda: _main(quick, ["--net", net]))
        want = {"crossbar_gemm": r["stages"], "fb_epilogue": r["stages"]}
        check(r["launches"] == want, f"quickstart {net}: run launched "
              f"{r['launches']}, expected {want}")
        check(r["roundtrip"], f"quickstart {net}: the loaded model differs")
        if net != "vit-tiny":
            check(r["exact"], f"quickstart {net}: not bit-exact on the card "
                  f"(rel {r['rel']:.3e})")
        else:
            check(r["rel"] <= quick.SEQ_REL
                  and r["prob_gap"] <= quick.SEQ_PROB_ATOL,
                  f"quickstart vit-tiny: rel {r['rel']:.3e}, probs "
                  f"{r['prob_gap']:.3e}")
        for k in launches:
            launches[k] += n[k]
        nets[net] = r
    return dict(nets=nets, launches=launches, alexnet_us=alex_us,
                sim=nets["resnet18"]["sim"])


def xbar_cpu_refs() -> dict:
    """(b)'s CPU references: ``evaluate`` of ``examples/
    crossbar_inference_torch.py`` on the weights and input its ``main``
    draws, batch ``XBAR_BATCH``, for each of ``XBAR_NETS``."""
    xb = _example("crossbar_inference_torch")
    return {net: xb.evaluate(net, *xb.inputs(net, XBAR_BATCH, "cpu"))
            for net in XBAR_NETS}


def xbar_example_phase(cpu_refs: dict) -> dict:
    """(b): ``examples/crossbar_inference_torch.py`` at batch 8 on the
    card against ``cpu_refs`` (``xbar_cpu_refs``): clean
    logits argmax 1.0 and ``XBAR_REL`` (``torch.equal`` printed), the
    noisy run's relative error within ``NOISE_REL`` of the CPU's, one
    ``crossbar_gemm`` launch per GEMM clean and none noisy."""
    import torch
    xb = _example("crossbar_inference_torch")
    nets, launches = {}, 0
    for net in XBAR_NETS:
        card, n = counted(lambda: _main(xb, ["--net", net, "--batch",
                                             str(XBAR_BATCH)]))
        cpu = cpu_refs[net]
        c, h = card["clean"], cpu["clean"]
        got, ref = c["logits"].cpu(), h["logits"]
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
        check(agree == 1.0 and rel <= XBAR_REL, f"crossbar_inference {net}: "
              f"clean card vs CPU argmax {agree}, rel {rel:.3e}")
        nz, nzc = card["noisy"], cpu["noisy"]
        check(abs(nz["rel"] - nzc["rel"]) <= NOISE_REL * nzc["rel"],
              f"crossbar_inference {net}: noisy rel-err card {nz['rel']:.4f} "
              f"vs CPU {nzc['rel']:.4f}")
        check(c["launches"] == c["gemms"] and nz["launches"] == 0
              and n["crossbar_gemm"] == c["gemms"],
              f"crossbar_inference {net}: launches clean {c['launches']} of "
              f"{c['gemms']} GEMMs, noisy {nz['launches']}")
        launches += n["crossbar_gemm"]
        nets[net] = dict(card=card, cpu=cpu, rel=rel, agree=agree,
                         exact=torch.equal(got, ref))
    return dict(nets=nets, launches=launches)


def _greedy_agreement(card: dict, cpu: dict, prompt: int) -> dict:
    """Continuation ids card against CPU up to the first step whose CPU
    top-two margin is under ``TIE`` of max |logit| (a near tie may flip
    under the devices' rounding differences), and that step's margin."""
    lg = cpu["logits"][:, prompt - 1:]               # the decode steps
    top = lg.topk(2, dim=-1).values
    margin = ((top[..., 0] - top[..., 1]).amin(0)
              / lg.abs().max()).tolist()
    stop = next((j for j, m in enumerate(margin) if m < TIE), len(margin))
    a, b = card["seqs"].cpu()[:, prompt:], cpu["seqs"][:, prompt:]
    equal = bool((a[:, :stop] == b[:, :stop]).all())
    diverge = next((j for j in range(a.shape[1])
                    if not bool((a[:, j] == b[:, j]).all())), None)
    same = (diverge if diverge is not None else a.shape[1]) + prompt - 1
    gap = ((card["logits"].cpu()[:, :same] - cpu["logits"][:, :same]).abs()
           .max() / cpu["logits"][:, :same].abs().max()).item()
    return dict(equal=equal, stop=stop, diverge=diverge, gap=gap,
                margin=margin[stop] if stop < len(margin) else None,
                min_margin=min(margin))


def _eager_generate(sv, *args, **kw) -> dict:
    """The example's ``generate`` with the eager ``make_decode_step`` in
    place of the compiled step it decodes through."""
    from repro_torch.serve.step import make_decode_step
    compiled = sv.compile_decode_step
    sv.compile_decode_step = make_decode_step
    try:
        return sv.generate(*args, **kw)
    finally:
        sv.compile_decode_step = compiled


def serve_example_phase() -> dict:
    """(c): ``examples/serve_lm_torch.py`` for ``SERVE_ARCHS`` on the card
    (through the compiled decode step: ids and every step's logits
    ``torch.equal`` to the same loop through the eager step on the card)
    against the CPU (``_greedy_agreement``), tokens/s, no launch of the
    six kernels; then ``python -m repro_torch.launch.serve --rounds 2``
    with no ``--device``: one capture over both rounds."""
    import torch
    sv = _example("serve_lm_torch")
    before = _launch_counts()
    archs = {}
    for arch in SERVE_ARCHS:
        card = _main(sv, ["--arch", arch])
        P = card["prompt_len"]
        eager = _eager_generate(sv, *sv.inputs(arch, card["batch"], P,
                                               "cuda"),
                                card["seqs"].shape[1] - P)
        check(torch.equal(card["seqs"], eager["seqs"])
              and torch.equal(card["logits"], eager["logits"]),
              f"serve_lm {arch}: the compiled step's ids or logits differ "
              "from the eager step's on the card")
        cpu = _main(sv, ["--arch", arch, "--device", "cpu"])
        ag = _greedy_agreement(card, cpu, card["prompt_len"])
        check(ag["equal"], f"serve_lm {arch}: card ids differ from the "
              f"CPU's before the first near tie (step {ag['stop']}): "
              f"{ag}")
        # the same loop in float32 on the CPU's inputs: ids as above, and
        # every step's logits within LM_TOL of max |logit|
        f32 = {d: sv.generate(*sv.inputs(arch, card["batch"],
                                         card["prompt_len"], d),
                              card["seqs"].shape[1] - card["prompt_len"],
                              compute_dtype=torch.float32)
               for d in ("cuda", "cpu")}
        a32 = _greedy_agreement(f32["cuda"], f32["cpu"], card["prompt_len"])
        check(a32["equal"] and a32["gap"] <= LM_TOL,
              f"serve_lm {arch} float32: card against CPU {a32}")
        archs[arch] = dict(ag, f32=a32, tok_s=card["tok_s"],
                           decode_ms=card["decode_ms"],
                           prefill_ms=card["prefill_ms"],
                           eager_tok_s=(card["seqs"].shape[1] - P)
                           * card["batch"] / eager["decode_s"])
    launched = {k: v - before[k] for k, v in _launch_counts().items()}
    check(not any(launched.values()),
          f"serve_lm launched kernels of repro_torch.kernels: {launched}")
    out = _run(["-m", "repro_torch.launch.serve", "--rounds", "2"])
    served, captures = out.strip().splitlines()[-2:]
    check("tok/s" in served and "NVIDIA" in served,
          f"launch.serve: served line {served!r}")
    check(captures == "decode step: 1 CUDA graph capture(s) over 2 rounds",
          f"launch.serve: {captures!r}")
    return dict(archs=archs, launched=launched, launcher=served,
                captures=captures)


def _params_gap(a_dir: str, b_dir: str, step: int) -> tuple[float, bool]:
    """Max over leaves of |a - b| / max |b| of step ``step``'s
    parameters in two checkpoint directories, and whether the parameters
    and optimizer states are equal."""
    import numpy as np
    gap, equal = 0.0, True
    for name in ("params", "opt_state"):
        path = f"step_{step}/{name}.npz"
        with np.load(os.path.join(a_dir, path)) as a, \
                np.load(os.path.join(b_dir, path)) as b:
            check(sorted(a.files) == sorted(b.files), f"{path}: keys differ")
            for k in b.files:
                equal &= bool(np.array_equal(a[k], b[k]))
                if name == "params":
                    scale = float(np.abs(b[k]).max())
                    gap = max(gap, float(np.abs(a[k] - b[k]).max()) / scale
                              if scale else 0.0)
    return gap, equal


def train_example_phase(tmp: str, wait=lambda: None) -> dict:
    """(d): ``examples/train_lm_torch.py`` at its own 100M config, b8 x
    256, with no ``--device``: ``--steps 60 --ckpt-every 20`` killed with
    SIGKILL once step 40's checkpoint is committed, rerun to 60 in the
    same directory (it resumes from 40), against an uninterrupted 60-step
    run through ``main`` here (ms per step, tokens/s, peak memory), to
    ``TRAIN_RESUME_TOL`` of max |param|.  ``wait`` returns once work
    running beside the two subprocesses is done, so that nothing shares
    the host with the timed run."""
    import signal
    killed, fresh = os.path.join(tmp, "killed"), os.path.join(tmp, "fresh")
    argv = ["examples/train_lm_torch.py", "--steps", str(TRAIN_EX["steps"]),
            "--ckpt-every", str(TRAIN_EX["every"]), "--ckpt-dir", killed]
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    commit = os.path.join(killed, f"step_{TRAIN_EX['kill']}", "meta.json")
    try:
        while not os.path.exists(commit) and p.poll() is None:
            time.sleep(0.01)
            check(time.perf_counter() - t0 < 300,
                  "train_lm: no step-40 checkpoint in 300 s")
        p.send_signal(signal.SIGKILL)
        _, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    check(p.returncode == -signal.SIGKILL,
          f"train_lm was not killed mid-run (exit {p.returncode}): "
          f"{err[-2000:]}")
    out = _run(argv)
    check(f"resumed from step {TRAIN_EX['kill']}" in out,
          f"train_lm did not resume from step {TRAIN_EX['kill']}: "
          f"{out[-500:]}")
    wait()
    tl = _example("train_lm_torch")
    r = _main(tl, ["--steps", str(TRAIN_EX["steps"]), "--ckpt-every",
                   str(TRAIN_EX["steps"]), "--ckpt-dir", fresh])
    gap, equal = _params_gap(killed, fresh, TRAIN_EX["steps"])
    check(gap <= TRAIN_RESUME_TOL, f"train_lm resumed vs uninterrupted: "
          f"{gap:.2e} of max |param| (limit {TRAIN_RESUME_TOL})")
    resumed = TRAIN_EX["steps"] - TRAIN_EX["kill"]
    captures = _capture_line(out)
    check(captures == f"train step: 1 CUDA graph capture(s) over {resumed} "
          "steps" and r["captures"] == 1,
          f"train_lm captures: resumed run {captures!r}, fresh run "
          f"{r['captures']}")
    return dict(gap=gap, equal=equal, ms=r["ms_per_step"], tok_s=r["tok_s"],
                peak_gb=r["peak_gb"], loss=r["losses"][-1],
                captures=captures, s=time.perf_counter() - t0)


def sigterm_phase(tmp: str) -> dict:
    """(e): ``python -m repro_torch.launch.train --reduced`` with no
    ``--device``, sent SIGTERM once a step line is printed: it saves the
    step it reached and exits 0; relaunched, it resumes to
    ``SIGTERM_STEPS``, against an uninterrupted run through ``main`` here
    at (d)'s tolerance."""
    import contextlib
    import signal
    from repro_torch.launch import train as launch_train
    stopped, fresh = os.path.join(tmp, "sigterm"), os.path.join(tmp, "f")
    argv = ["-m", "repro_torch.launch.train", "--arch", "internlm2_1_8b",
            "--reduced", "--steps", str(SIGTERM_STEPS), "--ckpt-dir",
            stopped]
    p = subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    lines = []
    try:
        for ln in p.stdout:
            lines.append(ln.rstrip())
            if ln.startswith("step "):
                p.send_signal(signal.SIGTERM)
                break
        rest, err = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    lines += rest.splitlines()
    for ln in lines:
        detail(f"  24e launch.train: {ln}")
    saved = [int(m.group(1)) for ln in lines
             if (m := re.match(r"\[preempt\] checkpointed at (\d+)", ln))]
    check(p.returncode == 0 and len(saved) == 1
          and saved[0] < SIGTERM_STEPS,
          f"launch.train after SIGTERM: exit {p.returncode}, saved {saved}: "
          f"{err[-2000:]}")
    out = _run(argv)
    check(f"[resume] step {saved[0]}" in out and "training complete" in out,
          f"launch.train did not resume from {saved[0]}: {out[-500:]}")
    with contextlib.redirect_stdout(sys.stderr):
        launch_train.main(argv[2:-1] + [fresh])
    gap, equal = _params_gap(stopped, fresh, SIGTERM_STEPS)
    check(gap <= TRAIN_RESUME_TOL, f"launch.train after SIGTERM vs "
          f"uninterrupted: {gap:.2e} of max |param|")
    return dict(saved=saved[0], gap=gap, equal=equal)


def v1_load_phase(api, model, tmp: str, gen) -> dict:
    """(f): ``model`` saved, rewritten as a version-1 file (parameters
    only, as ``tests/test_torch_api.py`` writes one) and ``api.load``-ed
    with no device: the repack runs on the card; batch 16 ``torch.equal``
    to the in-memory model."""
    import json as _json
    import numpy as np
    import torch
    path = model.save(os.path.join(tmp, "v3.npz"))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k.startswith("p")}
        meta = _json.loads(str(z["__meta__"][()]))
    meta["version"] = 1
    del meta["packed_stages"], meta["ln_stages"]
    v1 = os.path.join(tmp, "v1.npz")
    np.savez(v1, __meta__=np.asarray(_json.dumps(meta)), **arrays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = api.load(v1)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(loaded.device.type == "cuda", f"v1 load on {loaded.device}")
    x = torch.randn(model.program.input_shape(16), generator=gen,
                    device="cuda")
    got, n = counted(lambda: loaded.run(x, logits=True))
    check(torch.equal(got, model.run(x, logits=True)),
          "the version-1 file's model differs from the in-memory one")
    return dict(load_s=load_s, launches=n)


def execute_program_phase(model, gen) -> dict:
    """(g): ``program.execute_program`` on ResNet-18 at b16 (packing under
    the call) ``torch.equal`` to ``execute_packed``, one launch of each
    kernel per stage."""
    import torch
    from repro_torch.program import execute_packed, execute_program
    x = torch.randn(model.program.input_shape(16), generator=gen,
                    device="cuda")
    got, n = counted(lambda: execute_program(model.program, model.params, x,
                                             return_logits=True))
    stages = len(model.program.stages())
    check(n == each(stages),
          f"execute_program launches {n}, expected {stages} each")
    check(torch.equal(got, execute_packed(model.packed, x,
                                          return_logits=True)),
          "execute_program differs from execute_packed")
    ms = wall_ms(lambda: execute_program(model.program, model.params, x))
    packed_ms = wall_ms(lambda: execute_packed(model.packed, x))
    return dict(launches=n, ms=ms, packed_ms=packed_ms)


def examples_phase(dev) -> dict:
    """Phase 24: (a)-(g) above.  (b)'s CPU references are computed in a
    worker thread beside (d)'s two subprocesses, whose times are not
    kept; every timed part runs with the host to itself."""
    import tempfile
    import torch
    from repro_torch import api
    gen = torch.Generator(device=dev).manual_seed(24)
    out, secs = {}, {}
    resnet = api.compile("resnet18", api.HurryConfig(), seed=0, device=dev)

    def run(key: str, fn) -> None:
        t0 = time.perf_counter()
        out[key] = fn()
        secs[key] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        run("quick", quickstart_phase)
        run("serve", serve_example_phase)
        refs = pool.submit(xbar_cpu_refs)
        run("train", lambda: train_example_phase(tmp, refs.result))
        run("xbar", lambda: xbar_example_phase(refs.result()))
        run("sigterm", lambda: sigterm_phase(tmp))
        run("v1", lambda: v1_load_phase(api, resnet, tmp, gen))
        run("program", lambda: execute_program_phase(resnet, gen))
    out["secs"] = secs
    out["s"] = sum(secs.values())
    return out


def examples_line(ep: dict, card: str) -> str:
    """Phase 24's line on standard output."""
    q, xb, sv, tr, st = (ep[k] for k in ("quick", "xbar", "serve", "train",
                                         "sigterm"))
    quick = "; ".join(
        f"{net} {r['stages']} stages bit-exact {r['exact']}"
        + (f" (rel {r['rel']:.2e}, probs {r['prob_gap']:.2e})"
           if net == "vit-tiny" else "")
        + f" round trip {r['roundtrip']} {r['us']:.0f} us/batch{r['batch']}"
        for net, r in q["nets"].items())
    xbar = "; ".join(
        f"{net} clean vs CPU argmax {r['agree']} rel {r['rel']:.2e} "
        f"(torch.equal {r['exact']}), "
        + ", ".join(f"{k} {n}" for k, n in r["card"]["clean"]["branches"]
                    .items())
        + f", {r['card']['clean']['launches']} crossbar_gemm launches clean, "
        f"{r['card']['noisy']['launches']} noisy; noisy rel-err card "
        f"{r['card']['noisy']['rel']:.4f} / CPU {r['cpu']['noisy']['rel']:.4f}"
        f"; forward ms card fp32 {r['card']['fp32']['s'] * 1e3:.1f} clean "
        f"{r['card']['clean']['s'] * 1e3:.1f} noisy "
        f"{r['card']['noisy']['s'] * 1e3:.1f} (CPU noisy "
        f"{r['cpu']['noisy']['s'] * 1e3:.0f})"
        for net, r in xb["nets"].items())
    serve = "; ".join(
        f"{arch} ids equal to the CPU's "
        + (f"through step {a['stop']} (first near tie, CPU margin "
           f"{a['margin']:.2e})" if a["margin"] is not None
           else "at every step")
        + f", first differing step {a['diverge']}, logit gap before it "
        f"{a['gap']:.2e}; float32 ids equal through step {a['f32']['stop']}"
        f" (first differing {a['f32']['diverge']}), logit gap "
        f"{a['f32']['gap']:.2e}; bf16 {a['tok_s']:.0f} tok/s (ids and "
        f"logits torch.equal to the eager step's, {a['eager_tok_s']:.0f} "
        "tok/s)" for arch, a in sv["archs"].items())
    return (f"[24 examples] (a) quickstart: alexnet subprocess bit-exact "
            f"twice, {q['alexnet_us']:.0f} us/batch2; {quick}; launches "
            f"{q['launches']}; (b) "
            f"crossbar_inference b8: {xbar}; (c) serve_lm: {serve}; kernel "
            f"launches {sv['launched']}; launch.serve: {sv['launcher']}, "
            f"{sv['captures']}; "
            f"(d) train_lm 100M b8x256: killed after step "
            f"{TRAIN_EX['kill']}, resumed to {TRAIN_EX['steps']}: "
            f"{tr['gap']:.2e} of max |param| (torch.equal {tr['equal']}), "
            f"resumed run {tr['captures']}, fresh run 1 capture; "
            f"{tr['ms']:.1f} ms/step through compile_train_step (eager "
            f"{EAGER_TRAIN['example_ms']} recorded), {tr['tok_s']:.0f} "
            f"tokens/s, peak {tr['peak_gb']:.2f} GB; (e) launch.train "
            f"SIGTERM: saved step {st['saved']}, resumed to "
            f"{SIGTERM_STEPS}: {st['gap']:.2e} "
            f"(torch.equal {st['equal']}); (f) v1 load on the card "
            f"{ep['v1']['load_s']:.3f} s, b16 torch.equal; (g) "
            f"execute_program b16 torch.equal to execute_packed, launches "
            f"{ep['program']['launches']}, {ep['program']['ms']:.3f} ms "
            f"beside {ep['program']['packed_ms']:.3f}; phase {ep['s']:.1f} s ("
            + ", ".join(f"{k} {v:.1f}" for k, v in ep["secs"].items())
            + f") | {card}")


# ---------------------------------------------------------------------------
# phase 25: crossbar programs at other bit widths and array heights
# ---------------------------------------------------------------------------

# HurryConfig kwargs of the widths held (tests/test_torch_program.py's
# WIDTHS): narrower operands and ADCs on 512-row arrays, and smaller arrays
# (128 rows: the isaac-128 baseline's)
WIDTHS = {
    "w4a4_adc5": dict(input_bits=4, weight_bits=4, adc_bits=5),
    "w8a6_adc5": dict(input_bits=6, weight_bits=8, adc_bits=5),
    "w4a8_adc5": dict(input_bits=8, weight_bits=4, adc_bits=5),
    "w4a4_adc6": dict(input_bits=4, weight_bits=4, adc_bits=6),
    "rows256_adc8": dict(array_rows=256, adc_bits=8),
    "rows128_adc7": dict(array_rows=128, adc_bits=7),
}
WIDTH_NETS = (("resnet18", 16), ("alexnet", 4))      # (a): net, batch
WIDTH_VIT = ("w4a4_adc6", 16)                         # (a): width, batch
# (b): narrower ADCs on smaller arrays; every full chunk can clip
NARROW = tuple((adc, rows) for adc in (5, 6, 7) for rows in (128, 256))


def narrow_sliced_phase(dev, gen) -> dict:
    """(b): the sliced branch at every ``NARROW`` (adc, rows) against its
    plain version: M 1/4/16 x K 1458 x N 77 and a K of 40 chunks at M 4
    (where the kernel splits K by chunk) with a quarter of the rows and
    columns all ones, all -1 operands, and the chunk split on and off."""
    cases = [(adc, rows, M, 1458, 77) for adc, rows in NARROW
             for M in EDGE_M]
    cases += [(adc, rows, 4, 40 * rows, 64) for adc, rows in NARROW]
    worst, clipped = _sliced_cases(dev, gen, cases)
    for adc, rows in NARROW:
        _all_minus_one(dev, adc, rows)
    splits = {f"adc{adc}/rows{rows}": _split_on_and_off(
        dev, gen, False, 4, 40 * rows, 64, rows, adc)
        for adc, rows in NARROW}
    return dict(err=worst, cases=len(cases) + 2 * len(NARROW),
                clipped=clipped + len(NARROW), splits=splits)


def _branches(fn) -> tuple:
    """(fn(), calls): per ``crossbar_gemm`` call of the executor that a
    CUDA graph captures in this thread (a worker may run the CPU path
    meanwhile; the eager warm-up before the capture is not read), (K,
    rows, adc_bits, whether the exact kernel ran), the last read where
    the wrapper launches (``_launch``'s ``exact``).  ``fn`` runs a
    model's first request of a key, so each stage is read once, from the
    graph every replay of that key runs."""
    import threading
    import torch
    cg = importlib.import_module("repro_torch.kernels.crossbar_gemm")
    execute = importlib.import_module("repro_torch.program.execute")
    launch, gemm = cg._launch, execute.crossbar_gemm
    calls: list = []
    me = threading.get_ident()

    def captured() -> bool:
        return (threading.get_ident() == me
                and torch.cuda.is_current_stream_capturing())

    def spy_gemm(x8, w8=None, **kw):
        if captured():
            K = kw["K"] if w8 is None else w8.shape[-2]
            calls.append([K, kw["rows"], kw["adc_bits"], None])
        return gemm(x8, w8, **kw)

    def spy_launch(*args, **kw):
        if captured():
            calls[-1][3] = kw["exact"]
        return launch(*args, **kw)

    cg._launch, execute.crossbar_gemm = spy_launch, spy_gemm
    try:
        out = fn()
    finally:
        cg._launch, execute.crossbar_gemm = launch, gemm
    return out, calls


def _check_branches(name: str, model, calls) -> dict:
    """Each stage's ``crossbar_gemm`` launched the branch that
    ``clip_possible(min(rows, K), adc_bits)`` predicts for it: the static
    stages' K and rows those of the program (``layout_k``, ``tile_rows``),
    the dynamic stages' the runtime head dim or sequence length.  Returns
    the launches per branch."""
    from repro_torch.kernels import clip_possible
    from repro_torch.program.pack import layout_k
    stages = model.program.stages()
    check(len(calls) == len(stages) and all(c[3] is not None for c in calls),
          f"{name}: {len(calls)} crossbar_gemm calls for {len(stages)} "
          "stages, or one that launched no kernel")
    for (op, _), (K, rows, adc, exact) in zip(stages, calls):
        if op.kind != "dyn_gemm":
            want = (layout_k(op, model.program.cfg.adc_bits), op.tile_rows)
            check((K, rows) == want, f"{name} {op.name}: K, rows "
                  f"{(K, rows)} are not the program's {want}")
        check(adc == model.program.cfg.adc_bits
              and exact == (not clip_possible(min(rows, K), adc)),
              f"{name} {op.name}: K {K} rows {rows} adc {adc} launched the "
              f"{'exact' if exact else 'sliced'} branch")
    n_exact = sum(c[3] for c in calls)
    return {"exact": n_exact, "sliced": len(calls) - n_exact}


def _width_inputs(batch: int):
    import numpy as np
    return np.random.default_rng(25).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32)


def width_cpu_refs(api) -> dict:
    """The CPU plain path's logits on the same weights and inputs, for
    every (net, width) of (a)."""
    out = {}
    for net, batch in WIDTH_NETS:
        for name, kw in WIDTHS.items():
            model = api.compile(net, api.HurryConfig(**kw), seed=0,
                                device="cpu")
            out[net, name] = model.run(_width_inputs(batch), logits=True)
    return out


def widths_phase(dev, gen, meanwhile=None) -> dict:
    """Phase 25: (b) the sliced branch at ``NARROW`` on the kernel, then (a)
    ResNet-18 b16 and AlexNet b4 compiled on the card at every ``WIDTHS``
    row, run once with the three launch counters counted, and held to the CPU
    plain path on the same weights and inputs (``torch.equal``, computed
    in a worker thread meanwhile), each stage's branch against
    ``clip_possible``, and time per batch (``wall_ms``) beside the 8/8/9
    default's; vit_tiny b16 at ``WIDTH_VIT``: every stage teacher-forced
    from the CPU path's buffers (int32 GEMM outputs ``torch.equal``, FB
    outputs within ``FB_CASES``' tolerances), its branches, the free run
    against the CPU (argmax equal, ``VIT_REL`` / ``VIT_PROB_ATOL``; at 4
    bits a last-ulp difference that lands on an exact quantization tie
    moves a value by a seventh of its range, as against JAX on the CPU:
    ``ROADMAP.md`` section 3), and its time beside the default's.
    ``meanwhile()``, where given, runs on the card while the CPU side
    finishes (it must patch nothing of the executor); its result is
    ``out["meanwhile"]``."""
    import torch
    from repro_torch import api
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(width_cpu_refs, api)
        out = dict(narrow=narrow_sliced_phase(dev, gen), nets={},
                   launches=each(0), sliced=0)

        def run(net: str, cfg, x) -> dict:
            model = api.compile(net, cfg, seed=0, device="cuda")
            (logits, calls), n = counted(lambda: _branches(
                lambda: model.run(x, logits=True)))
            want = forward_launches(model.program, 2)   # warm-up, replay
            check(n == want, f"{net} launches {n}, expected {want}")
            for k in n:
                out["launches"][k] += n[k]
            branches = _check_branches(net, model, calls)
            out["sliced"] += branches["sliced"]
            return dict(model=model, logits=logits.cpu(),
                        branches=branches, us=wall_ms(lambda: model.run(x))
                        * 1e3)

        for net, batch in WIDTH_NETS:
            x = _width_inputs(batch)
            default = api.compile(net, api.HurryConfig(), seed=0,
                                  device="cuda")
            r = dict(default_us=wall_ms(lambda: default.run(x)) * 1e3,
                     widths={})
            for name, kw in WIDTHS.items():
                w = run(net, api.HurryConfig(**kw), x)
                del w["model"]
                r["widths"][name] = w
            out["nets"][net] = r
        name, batch = WIDTH_VIT
        x = _width_inputs(batch)
        vit = run("vit_tiny", api.HurryConfig(**WIDTHS[name]), x)
        default = api.compile("vit_tiny", api.HurryConfig(), seed=0,
                              device="cuda")
        vit["default_us"] = wall_ms(lambda: default.run(x)) * 1e3
        probs = vit["model"].run(x).cpu()
        if meanwhile is not None:
            out["meanwhile"] = meanwhile()
        cpu = refs.result()
    # vit_tiny's CPU side records its stages (``record_stages`` patches
    # the executor), so it runs with no card forward beside it
    vit_cpu = api.compile("vit_tiny", api.HurryConfig(**WIDTHS[name]),
                          seed=0, device="cpu")
    cpu["vit"] = dict(recs=record_stages(vit_cpu, x)[1],
                      probs=vit_cpu.run(x), logits=vit_cpu.run(x, logits=True))
    for net, r in out["nets"].items():
        for name, w in r["widths"].items():
            check(torch.equal(w["logits"], cpu[net, name]),
                  f"{net} {name}: logits on the card differ from the CPU "
                  "plain path's")
    forced = teacher_forced(vit["model"], cpu["vit"]["recs"])
    for f in forced:
        check(f["gemm_equal"] and f["fb_err"] <= f["fb_atol"]
              and f["parts_equal"] is not False,
              f"vit_tiny {name} teacher-forced stage {f['name']}: int32 "
              f"equal {f['gemm_equal']}, FB off by {f['fb_err']:.2e} "
              f"(limit {f['fb_atol']}), partial maxima equal to max |FB| "
              f"{f['parts_equal']}")
    ref, got = cpu["vit"]["logits"], vit["logits"]
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(probs)
                                                   .all()),
          "vit_tiny non-finite on the card")
    vit.update(rel=((got - ref).abs().max() / ref.abs().max()).item(),
               prob=(probs - cpu["vit"]["probs"]).abs().max().item(),
               agree=(got.argmax(1) == ref.argmax(1)).float().mean().item(),
               forced=len(forced),
               fb_err=max(f["fb_err"] for f in forced))
    check(vit["agree"] == 1.0 and vit["rel"] <= VIT_REL
          and vit["prob"] <= VIT_PROB_ATOL,
          f"vit_tiny {name} b{batch} card vs CPU: argmax agreement "
          f"{vit['agree']}, rel {vit['rel']:.2e} (limit {VIT_REL}), probs "
          f"{vit['prob']:.2e} (limit {VIT_PROB_ATOL})")
    del vit["model"]
    out["vit"] = vit
    out["s"] = (time.perf_counter() - t0
                - out.get("meanwhile", {}).get("s", 0.0))
    return out


def widths_line(wp: dict, card: str) -> str:
    """Phase 25's line on standard output."""
    nb, v = wp["narrow"], wp["vit"]
    nets = "; ".join(
        f"{net} b{batch} (default 8/8/9 {wp['nets'][net]['default_us']:.0f} "
        "us/batch): " + ", ".join(
            f"{name} exact/sliced {w['branches']['exact']}/"
            f"{w['branches']['sliced']} {w['us']:.0f} us"
            for name, w in wp["nets"][net]["widths"].items())
        for net, batch in WIDTH_NETS)
    name, batch = WIDTH_VIT
    return (f"[25 widths] (a) every width's logits torch.equal to the CPU "
            f"plain path, each stage on the branch clip_possible predicts; "
            f"{nets}; vit_tiny {name} b{batch}: {v['forced']} stages "
            f"teacher-forced (int32 torch.equal, FB max err "
            f"{v['fb_err']:.2e}), exact/sliced {v['branches']['exact']}/"
            f"{v['branches']['sliced']}, free run vs CPU rel "
            f"{v['rel']:.2e} probs {v['prob']:.2e} argmax agreement "
            f"{v['agree']:.4f} (limits VIT_REL {VIT_REL}, VIT_PROB_ATOL "
            f"{VIT_PROB_ATOL}), {v['us']:.0f} us beside the default's "
            f"{v['default_us']:.0f}; launches {wp['launches']} "
            f"({wp['sliced']} sliced); (b) sliced branch at adc/rows "
            + ", ".join(f"{a}/{r}" for a, r in NARROW)
            + f": {nb['cases']} cases equal to the plain version (max err "
            f"{nb['err']}), clips fired in {nb['clipped']}, chunk split "
            + ", ".join(f"{k} {v_}" for k, v_ in nb["splits"].items())
            + f" and 1; phase {wp['s']:.1f} s (26 (a) beside it not "
            f"counted) | {card}")


# ---------------------------------------------------------------------------
# phase 26: every LM family at its published width
# ---------------------------------------------------------------------------

# (a): each arch but Qwen3-8B (phase 21 (b)) at full width, its depth cut
# to the fewest layers that hold one of every block kind: one Zamba2 group
# of 6 Mamba2 blocks and the shared attention, one xLSTM group of 7 mLSTM
# blocks and an sLSTM, Whisper's encoder and decoder 2 each
WIDE_CUTS = {
    "internlm2_1_8b": dict(n_layers=2),
    "phi3_medium_14b": dict(n_layers=2),
    "granite_34b": dict(n_layers=2),
    "qwen2_vl_72b": dict(n_layers=2),
    "mixtral_8x22b": dict(n_layers=2),
    "granite_moe_3b_a800m": dict(n_layers=2),
    "zamba2_2_7b": dict(n_layers=6),
    "xlstm_1_3b": dict(n_layers=8),
    "whisper_medium": dict(n_layers=2, encoder_layers=2),
}
WIDE = dict(batch=2, seq=64, steps=8)
# (b): the archs whose bfloat16 weights fit one card, at full width and
# depth: decode against forward over `teacher` tokens (batch 2), prefill at
# batch 1 (Whisper: `prompt` decoder tokens over its 1500 frames),
# greedy_generate at `batch` with a `prompt`-token prompt and `new` tokens
SERVED = ("granite_moe_3b_a800m", "zamba2_2_7b", "xlstm_1_3b",
          "whisper_medium", "phi3_medium_14b")
SERVE_WIDE = dict(teacher=32, prefill=2048, batch=4, prompt=64, new=32)
# prefill lengths profiled for busy time and idle share where the served
# prefill launches too much to trace in the phase's time: xLSTM's sLSTM
# steps token by token (some 10^5 kernels at 2048 tokens)
PROFILED_PREFILL = {"xlstm_1_3b": 256}
# tests/test_archs_smoke.py's MoE correlation (capacity drops in the
# forward, none in a 1-token decode step); its argmax agreement (0.7) is
# printed, not held: at granite-moe's published routing (40 experts, top
# 8; capacity 8 a row at 32 tokens) the JAX package's own decode agrees
# with its forward on 0.578 of positions (reduced width, float32; the
# port's forward within 6e-7 of JAX's there)
MOE_CORR = 0.9
# archs whose bfloat16 decode-against-forward correlation is printed, not
# held: xLSTM's bfloat16 run drifts from its own float32 run with depth,
# forward and decode alike (correlation to float32 0.996 at 8 layers,
# 0.75-0.77 at 48 on an H100), and the JAX package's decode-against-
# forward falls the same way on the CPU (0.9975 at 8 layers, 0.985 at
# 16); its float32 compute pins the recurrent steps to the chunked scans
BF16_DRIFT = ("xlstm_1_3b",)
# part 3: the int8 KV cache at the served Qwen3-8B cache's shape (batch 8,
# 8 kv heads of 128) on a ring of `slots` positions, `steps` one-token
# updates (two wraps) and an `append`-token one at step `at`, whose slot
# (14) is clipped back so the update fits, as XLA clips it;
# tests/test_kv_quant.py's rtol / atol for attention over the int8 cache
KV_RING = dict(batch=8, slots=16, steps=40, append=4, at=30)
KV_ATTN_TOL = 0.05


def _wide_ref(cfg, params, tokens, frames, got) -> dict:
    """(a)'s CPU side: the same float32 forward and decode steps on the CPU
    copy of the weights, each part's gap to the card's relative to max
    |logit|."""
    import torch
    want = lm_logits(cfg, params, tokens, frames, WIDE["steps"],
                     torch.float32)
    return {part: _rel(g, w) for part, g, w in
            zip(("forward", "encode", "decode"), got, want)
            if w is not None}


def lm_wide(dev) -> dict:
    """(a): every ``WIDE_CUTS`` arch at full width, float32 weights drawn
    on the card: forward at ``WIDE`` batch x seq and ``WIDE['steps']``
    teacher-forced decode steps on the card against the CPU on a copy of
    the same weights, to ``LM_TOL``.  Each arch's CPU side runs in a worker
    thread while the next arch runs on the card (two CPU copies at most)."""
    import torch
    from repro_torch.models import lm
    errs, pending = {}, None
    b, s, steps = WIDE["batch"], WIDE["seq"], WIDE["steps"]
    f32 = torch.float32

    def done(arch, fut) -> None:
        errs[arch] = e = fut.result()
        check(all(v <= LM_TOL for v in e.values()),
              f"{arch} full width card vs CPU {e} (limit {LM_TOL})")
        detail(f"  26a {arch}: " + ", ".join(f"{k} {v:.2e}"
                                            for k, v in e.items()))

    with ThreadPoolExecutor(1) as pool:
        for i, (arch, kw) in enumerate(WIDE_CUTS.items()):
            cfg = _full(arch, **kw)
            gen = torch.Generator(dev).manual_seed(260 + i)
            params = lm.init_params(cfg, gen, device=dev)
            tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                   generator=gen)
            frames = (torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                  device=dev, generator=gen)
                      if cfg.is_encdec else None)
            got = [None if t is None else t.cpu() for t in
                   lm_logits(cfg, params, tokens, frames, steps, f32)]
            for part, g in zip(("forward", "encode", "decode"), got):
                check(g is None or bool(torch.isfinite(g).all()),
                      f"{arch} {part}: non-finite on the card")
            host = _tree(lambda t: t.cpu(), params)
            del params
            torch.cuda.empty_cache()
            if pending is not None:
                done(*pending)
            pending = (arch, pool.submit(
                _wide_ref, cfg, host, tokens.cpu(),
                None if frames is None else frames.cpu(), got))
            del host
        done(*pending)
    return errs


def _uses(cfg, path: str, S: int, enc_S: int, encoder: bool) -> int:
    """How many rows go through a matrix leaf at ``path`` in one forward
    of ``S`` tokens at batch 1 over ``enc_S`` encoder frames (the encoder
    run too where ``encoder``): what the code computes, so the MoE
    experts count their capacity slots and Zamba2's shared block each of
    its applications; 0 for the embedding table (a gather)."""
    if path == "embed":
        return S if cfg.tie_embeddings else 0
    if path.startswith("enc_blocks/"):
        return enc_S if encoder else 0
    if path.startswith("dec_blocks/cross_attn/w") and path[-2:] in ("wk",
                                                                    "wv"):
        return enc_S
    if "/moe/w_" in path:
        return max(1, int(1.25 * S * cfg.experts_per_token / cfg.n_experts))
    if path.startswith("shared/"):
        return S * (cfg.n_layers // cfg.shared_attn_every)
    return S


def lm_flop(cfg, params, S: int, enc_S: int = 0, keys: int = 0,
            encoder: bool = True) -> float:
    """The products of one forward over ``S`` tokens at batch 1 against
    ``keys`` keys (``S`` when 0): every matrix leaf times the rows through
    it (``_uses``), and 4 * hd operations per (query, key) pair of every
    attention (all keys, as ``mha`` and ``mha_chunked`` compute them);
    the recurrent scans of Mamba2, mLSTM and sLSTM are not counted (a
    lower bound)."""
    from repro_torch.tree import tree_items
    flop = sum(2 * t.numel() * _uses(cfg, path, S, enc_S, encoder)
               for path, t in tree_items(params) if t.ndim >= 2)
    keys = keys or S
    pairs = 0
    if cfg.family in ("dense", "moe", "vlm"):
        pairs = cfg.n_layers * S * keys
    elif cfg.family == "hybrid":
        pairs = cfg.n_layers // cfg.shared_attn_every * S * keys
    elif cfg.family == "audio":
        pairs = (cfg.encoder_layers * enc_S * enc_S * encoder
                 + cfg.n_layers * (S * keys + S * enc_S))
    return flop + 4 * cfg.n_heads * cfg.resolved_head_dim * pairs


def lm_served(dev, arch: str, seed: int) -> dict:
    """(b) for one arch: full width and depth, bfloat16 weights drawn on
    the card; decode against forward in float32 and bfloat16 compute;
    ``make_prefill_step``, ``greedy_generate`` and a decode step timed
    beside their floors, with busy time, idle share and peak memory."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve.step import (greedy_generate, make_decode_step,
                                        make_prefill_step)
    from repro_torch.tree import tree_items
    start = time.perf_counter()
    cfg = _full(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(dev).manual_seed(seed)
    params = lm.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nbytes = {path: t.numel() * t.element_size()
              for path, t in tree_items(params)}
    weight_b = sum(nbytes.values())
    # what a forward reads: every weight but the embedding table (a
    # gather), unless it is also the head; a decode step not the encoder
    read_b = weight_b - (0 if cfg.tie_embeddings else nbytes["embed"])
    step_b = read_b - sum(n for path, n in nbytes.items()
                          if path.startswith("enc_"))
    enc = cfg.encoder_seq if cfg.is_encdec else 0

    def frames(batch: int):
        return (torch.randn((batch, enc, cfg.d_model), device=dev,
                            generator=gen, dtype=torch.bfloat16)
                if enc else None)

    T = SERVE_WIDE["teacher"]
    tokens = torch.randint(0, cfg.vocab_size, (2, T), device=dev,
                           generator=gen)
    fr = frames(2)
    out = dict(gb=weight_b / 1e9, init_peak_gb=init_peak)
    corr_min = MOE_CORR if cfg.n_experts else QWEN_CORR
    f32_fwd = None
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fwd, _, dec = lm_logits(cfg, params, tokens, fr, T, dtype)
        agree, corr = _agreement(fwd, dec)
        finite = bool(torch.isfinite(dec).all() & torch.isfinite(fwd).all())
        out[name] = dict(agree=agree, corr=corr)
        if f32_fwd is None:
            f32_fwd = fwd.float()
        else:            # the bfloat16 forward against the float32 one
            out[name]["to_f32"] = _agreement(f32_fwd, fwd)[1]
        # agreement held in float32 compute and not for MoE (see
        # MOE_CORR); the correlation in both but for BF16_DRIFT in bf16
        check(finite and (corr > corr_min or (name == "bf16"
                                              and arch in BF16_DRIFT))
              and (agree > QWEN_AGREE or name == "bf16" or cfg.n_experts),
              f"{arch} {name} compute: decode vs forward agreement "
              f"{agree:.4f} (> {QWEN_AGREE}), correlation {corr:.5f} "
              f"(> {corr_min}), finite {finite}")
        del fwd, dec

    S = SERVE_WIDE["prompt"] if enc else SERVE_WIDE["prefill"]
    prompt = torch.randint(0, cfg.vocab_size, (1, S), device=dev,
                           generator=gen)
    fr1 = frames(1)
    prefill = make_prefill_step(cfg)
    last = prefill(params, prompt, fr1)
    check(last.shape == (1, cfg.padded_vocab)
          and bool(torch.isfinite(last).all()),
          f"{arch} prefill logits {tuple(last.shape)} not finite")
    del last
    out["prefill_tokens"] = S
    # the call above warmed the prefill, and phase 21 the profiler (the
    # sLSTM's loop launches some 10^5 kernels a prefill)
    out["prefill_ms"] = wall_ms(lambda: prefill(params, prompt, fr1), runs=3,
                                warmup=1)
    # busy time and idle share at PROFILED_PREFILL's length where it is
    # shorter, with that length's own wall time
    S_prof = PROFILED_PREFILL.get(arch, S)
    short = prompt[:, :S_prof]
    out["profiled_tokens"] = S_prof
    out["profiled_ms"] = out["prefill_ms"] if S_prof == S else wall_ms(
        lambda: prefill(params, short, fr1), runs=3, warmup=1)
    out["prefill_busy"], _ = forward_profile(
        lambda: prefill(params, short, fr1), runs=1, top=None, warm=False)
    flop = lm_flop(cfg, params, S, enc)
    out["prefill_tflop"] = flop / 1e12
    out["prefill_floor"] = max(flop / BF16_OPS_PER_S,
                               read_b / HBM_BYTES_PER_S) * 1e3

    B, P, N = (SERVE_WIDE[k] for k in ("batch", "prompt", "new"))
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=gen, dtype=torch.int32)
    states = lm.encode(params, cfg, frames(B)) if enc else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_out = greedy_generate(cfg, params, prompt, N, encoder_states=states)
    torch.cuda.synchronize()
    out["generate_s"] = time.perf_counter() - t0
    check(gen_out.shape == (B, P + N) and torch.equal(gen_out[:, :P], prompt)
          and bool(((gen_out >= 0) & (gen_out < cfg.padded_vocab)).all()),
          f"{arch} greedy_generate output {tuple(gen_out.shape)} wrong")
    decode = make_decode_step(cfg)
    caches = lm.init_caches(cfg, B, P + N, params=params)
    tok = gen_out[:, P:P + 1]
    pos = torch.tensor(P, dtype=torch.int32, device=dev)
    step = lambda: decode(params, tok, caches, pos,         # noqa: E731
                          encoder_states=states)
    out["step_ms"] = wall_ms(step, runs=5)
    out["step_busy"], _ = forward_profile(step, runs=3, top=None)
    cache_b = sum(t.numel() * t.element_size()
                  for t in _tree_leaves(caches))
    # a step reads its weights (B rows of the embedding table), reads the
    # cache and writes its new copy; Whisper's cross K/V come from the
    # encoder states again at every step
    step_flop = B * lm_flop(cfg, params, 1, enc, keys=P + 1, encoder=False)
    out["step_floor"] = max(
        (step_b + B * cfg.d_model * 2 + 2 * cache_b) / HBM_BYTES_PER_S,
        step_flop / BF16_OPS_PER_S) * 1e3
    out["tok_s"] = B / out["step_ms"] * 1e3
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del caches
    # the same greedy loop through the compiled step beside the eager one
    # (and, for MoE, beside a second eager loop: top-k index_add_ atomics)
    out["replay"] = decode_replay(cfg, params, prompt, N, states,
                                  repeat=bool(cfg.n_experts))
    for ms, n, kname in out["replay"].pop("top")[:8]:
        detail(f"  26b {arch} replayed step: {kname}: {ms:.3f} ms in {n} "
               "launches")
    for k in ("gaps", "eager_gaps"):
        detail(f"  26b {arch} {k} per step: {out['replay'].pop(k)}")
    replay_held(arch, out["replay"])
    del params, states
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - start
    return out


def kv_ring_phase(dev) -> dict:
    """Part 3: ``update_quant_cache`` on the card and on the CPU over
    ``KV_RING``'s ring, every field ``torch.equal`` after every update,
    ``read_quant_cache`` equal, and ``_decode_mha`` over the dequantised
    int8 cache within ``KV_ATTN_TOL`` of the same attention over a float32
    ring given the same updates (``dynamic_update_slice``)."""
    import torch
    from repro_torch.models.layers import (_decode_mha, dynamic_update_slice,
                                           init_kv_cache)
    from repro_torch.serve.kv_quant import (init_quant_kv_cache,
                                            read_quant_cache,
                                            update_quant_cache)
    cfg = _full("qwen3_8b")
    b, slots = KV_RING["batch"], KV_RING["slots"]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(26)
    devs = (torch.device("cpu"), dev)
    q8 = {d: init_quant_kv_cache(b, slots, cfg, device=d) for d in devs}
    fl = {d: init_kv_cache(b, slots, cfg, torch.float32, device=d)
          for d in devs}
    n = 0
    for i in range(KV_RING["steps"]):
        s = KV_RING["append"] if i == KV_RING["at"] else 1
        k = torch.randn((b, s, hkv, hd), generator=gen) * 3
        v = torch.randn((b, s, hkv, hd), generator=gen)
        k[0, 0, 0] = 0                                  # a zero row
        for d in devs:
            q8[d] = update_quant_cache(q8[d], k.to(d), v.to(d))
            c = fl[d]
            slot = c["index"] % slots
            fl[d] = dict(k=dynamic_update_slice(c["k"], k.to(d), slot),
                         v=dynamic_update_slice(c["v"], v.to(d), slot),
                         index=c["index"] + s)
        for f in q8[devs[0]]:
            check(torch.equal(q8[dev][f].cpu(), q8[devs[0]][f]),
                  f"int8 KV cache field {f} differs card vs CPU after "
                  f"update {i}")
        n += 1
    reads = {d: read_quant_cache(q8[d], torch.float32) for d in devs}
    check(all(torch.equal(a.cpu(), r) for a, r in zip(reads[dev],
                                                       reads[devs[0]])),
          "read_quant_cache differs card vs CPU")
    q = torch.randn((b, 1, h, hd), generator=gen).to(dev)
    valid = torch.ones(slots, dtype=torch.bool, device=dev)
    out_q = _decode_mha(q, *reads[dev], valid, hd, h, hkv)
    out_f = _decode_mha(q, fl[dev]["k"], fl[dev]["v"], valid, hd, h, hkv)
    gap = (out_q - out_f).abs()
    check(bool((gap <= KV_ATTN_TOL + KV_ATTN_TOL * out_f.abs()).all()),
          f"attention over the int8 cache off the float one by "
          f"{gap.max().item():.3e} (rtol = atol = {KV_ATTN_TOL})")
    index = int(q8[dev]["index"])
    return dict(shape=tuple(q8[dev]["k"].shape), updates=n, index=index,
                wraps=index // slots, attn_gap=gap.max().item())


def lm_wide_a(dev) -> dict:
    """(a) with the six kernel-launch counters read before and after:
    (errors, launches, seconds)."""
    t0, before = time.perf_counter(), _launch_counts()
    errs = lm_wide(dev)
    after = _launch_counts()
    return dict(errs=errs, launched={k: after[k] - before[k] for k in after},
                s=time.perf_counter() - t0)


def lm_wide_phase(dev, wide: dict | None = None) -> dict:
    """Phase 26: (a) (run here unless ``wide``, ``lm_wide_a``'s result,
    says it ran already), (b) and part 3 above, with (c) the six
    kernel-launch counters unchanged across all of them."""
    wide = wide or lm_wide_a(dev)
    t0 = time.perf_counter()
    before = _launch_counts()
    out = dict(wide=wide["errs"], wide_s=wide["s"], served={})
    for i, arch in enumerate(SERVED):
        out["served"][arch] = r = lm_served(dev, arch, 2600 + i)
        detail(f"  26b {arch}: {r}")
    out["kv"] = kv_ring_phase(dev)
    after = _launch_counts()
    out["launched"] = {k: after[k] - before[k] + wide["launched"][k]
                       for k in after}
    check(not any(out["launched"].values()), f"phase 26 launched kernels "
          f"of repro_torch.kernels: {out['launched']}")
    out["s"] = time.perf_counter() - t0 + wide["s"]
    return out


def lm_wide_line(lp: dict, card: str) -> str:
    """Phase 26's line on standard output."""
    busy = (lambda b, ms: "busy not measured" if b is None
            else f"{b:.1f} ms busy, idle {1 - b / ms:.1%}")
    served = "; ".join(
        f"{arch} bf16 {r['gb']:.2f} GB (init peak {r['init_peak_gb']:.1f}):"
        f" decode vs forward f32 agreement {r['f32']['agree']:.4f} "
        f"correlation {r['f32']['corr']:.5f}, bf16 {r['bf16']['agree']:.4f}"
        f"/{r['bf16']['corr']:.5f}"
        f"{' (printed, not held)' if arch in BF16_DRIFT else ''}, bf16 "
        f"forward vs f32 correlation {r['bf16']['to_f32']:.5f}; prefill "
        f"b1x{r['prefill_tokens']} "
        f"{r['prefill_ms']:.2f} ms (floor {r['prefill_floor']:.2f}: "
        f"{r['prefill_tflop']:.2f} TFLOP / bf16 peak, weights / HBM; "
        + (f"{busy(r['prefill_busy'], r['prefill_ms'])}"
           if r["profiled_tokens"] == r["prefill_tokens"] else
           f"b1x{r['profiled_tokens']} {r['profiled_ms']:.2f} ms, "
           f"{busy(r['prefill_busy'], r['profiled_ms'])}")
        + f"); decode step b"
        f"{SERVE_WIDE['batch']} {r['step_ms']:.2f} ms (floor "
        f"{r['step_floor']:.3f}; {busy(r['step_busy'], r['step_ms'])}) = "
        f"{r['tok_s']:.1f} tok/s; compiled: "
        + replay_text(r["replay"], r["step_ms"], r["step_floor"])
        + f"; greedy_generate {r['generate_s']:.2f} s; "
        f"peak {r['peak_gb']:.1f} GB; {r['s']:.1f} s"
        for arch, r in lp["served"].items())
    kv = lp["kv"]
    return (f"[26 LM full width] (a) card vs CPU float32, b{WIDE['batch']}x"
            f"{WIDE['seq']} forward + {WIDE['steps']} decode steps, max rel "
            "to max|logit| (forward/encode/decode): " + ", ".join(
                f"{a} ({WIDE_CUTS[a]['n_layers']} layers) "
                + "/".join(f"{v:.1e}" for v in e.values())
                for a, e in lp["wide"].items())
            + f" (limit {LM_TOL}), {lp['wide_s']:.1f} s; (b) full depth "
            "served, "
            f"{SERVE_WIDE['teacher']} teacher-forced steps (held f32 > "
            f"{QWEN_AGREE}/{QWEN_CORR}, MoE correlation > {MOE_CORR}; bf16 "
            f"correlation only, but {'/'.join(BF16_DRIFT)}), "
            f"greedy_generate b{SERVE_WIDE['batch']} "
            f"prompt {SERVE_WIDE['prompt']} + {SERVE_WIDE['new']} new: "
            f"{served} (host clock + synchronize, median of 3 / 5); (c) "
            f"kernel launches {lp['launched']}; part 3 int8 KV cache "
            f"{kv['shape']}: {kv['updates']} updates to index {kv['index']}"
            f" ({kv['wraps']} wraps, a {KV_RING['append']}-token append), "
            "every field and read_quant_cache torch.equal card vs CPU, "
            f"_decode_mha int8 vs float32 max gap {kv['attn_gap']:.3e} "
            f"(rtol = atol = {KV_ATTN_TOL}); phase {lp['s']:.1f} s | {card}")


# ---------------------------------------------------------------------------
# phase 27: the front door's one executable per (bucket, flavor, shape)
# ---------------------------------------------------------------------------

EXEC_NETS = (("resnet18", {}), ("alexnet", dict(adc_bits=8)), ("vgg16", {}),
             ("vit_tiny", {}), ("vit_s16", {}))
EXEC_BATCHES = (1, 3, 16)        # buckets 1, 4, 16
EXEC_TOKENS = (16, 32)           # the token-input graph's T: a key each
EXEC_TIMED = (1, 4, 16)          # 4: AlexNet adc8's batch in phases 6-7
# the kernels each program-path wrapper launches: functions in an
# anonymous namespace of csrc/<wrapper>.cu, as the profiler names them
KERNEL_NAMES = {"crossbar_gemm": ("exact_kernel", "sliced_kernel"),
                "fb_epilogue": ("elementwise_kernel", "pool_kernel",
                                "rows_warp_kernel", "seqmean_kernel",
                                "rows_kernel", "rows_warp_tap_kernel",
                                "rows_tap_kernel"),
                "quantize_layout": ("one_conv_kernel", "one_rows_kernel",
                                    "partials_conv_kernel",
                                    "partials_rows_kernel", "image_kernel",
                                    "gather_kernel",
                                    "quantize_rows_kernel")}


def token_graph(api):
    """A token-input graph (the batch's T is a run-time property):
    attention, residual, layer norm, MLP with GELU, sequence mean, fc,
    softmax (``tests/test_torch_cuda.py``'s)."""
    nb = api.NetworkBuilder("tok", input_seq_dim=32)
    nb.attention(4, name="attn")
    nb.residual("input", name="r1")
    ln = nb.layernorm(name="ln1")
    nb.linear(64, name="fc1")
    nb.gelu(name="g1")
    nb.linear(32, name="fc2")
    nb.residual(ln, name="r2")
    nb.layernorm(name="ln2")
    nb.seqpool(name="pool")
    nb.fc(10, name="head")
    nb.softmax(name="sm")
    return nb.build()


def eager_run(model, x, logits: bool = False):
    """``execute_packed`` itself (no graph) on ``x`` padded to its bucket,
    sliced back: what a replay of ``model.run`` (or a server's call) must
    equal."""
    from repro_torch.program.execute import execute_packed
    from repro_torch.program.serve import bucket_batch, pad_batch
    b = x.shape[0]
    x = pad_batch(x, bucket_batch(b, model.buckets))
    return execute_packed(model.packed, x, return_logits=logits)[:b]


def hold_replays(name: str, model, answer, shapes, flavors, gen) -> dict:
    """Per input shape and flavor, two draws through ``answer(x, logits)``
    (``model.run``, a server or a loaded model): the first request
    captures the key, the second replays it; both answers kept, then each
    ``torch.equal`` to eager ``execute_packed`` on its own draw (the
    first read after the second ran: no aliasing), finite, and the
    counters one launch of each kernel per stage for each request and
    each key's warm-up (two of ``quantize_layout`` a dynamic stage:
    ``forward_launches``).  Returns the launches and the keys' capture
    seconds."""
    import torch
    n = len(model.program.stages())
    launches = each(0)
    for shape in shapes:
        for logits in flavors:
            xs = [torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(2)]
            keys = len(model._fns)
            got, c = counted(lambda: [answer(x, logits) for x in xs])
            warm = len(model._fns) - keys
            check(c == forward_launches(model.program, 2 + warm),
                  f"{name} {shape} logits={logits}: launches {c} for two "
                  f"requests and {warm} warm-up of {n} stages")
            for i, (x, r) in enumerate(zip(xs, got)):
                want = eager_run(model, x, logits)
                check(r.shape == want.shape and torch.equal(r, want)
                      and bool(torch.isfinite(r).all()),
                      f"{name} {shape} logits={logits} draw {i}: the replay "
                      "differs from eager execute_packed")
            for k in launches:
                launches[k] += c[k]
    return dict(launches=launches, capture_s={
        key: fn.capture_s for key, fn in model._fns.items()})


def busy_by_wrapper(top: list) -> dict:
    """``forward_profile``'s kernels (ms, launches, name) summed by the
    wrapper whose source defines them (``KERNEL_NAMES``), the rest under
    ``other``: device ms per call."""
    out = dict.fromkeys([*KERNEL_NAMES, "other"], 0.0)
    for ms, _, name in top:
        m = re.search(r"\(anonymous namespace\)::(\w+)", name)
        owner = next((k for k, names in KERNEL_NAMES.items()
                      if m and m.group(1) in names), "other")
        out[owner] += ms
    return out


def replay_kernels(fn, sessions: int = 3, others: dict | None = None
                   ) -> dict:
    """The device's kernels in one call of ``fn`` (profiler device
    events), counted by the wrapper whose source defines them
    (``KERNEL_NAMES``); the rest (copies, fills, PyTorch's kernels) under
    ``other``.  Late in a long process the profiler misses the first
    device events of a session (PR 20's and PR 21's smoke runs counted
    two kernels fewer than the same replay alone): each session starts
    with four sentinel kernels (``torch.cuda._sleep``, PyTorch's
    ``spin_kernel``), left out of the counts, and each count is the
    largest of ``sessions`` profiled calls (the profiler drops events,
    it does not invent them).  ``others``, where given, is filled with
    the ``other`` kernels by name (the largest count of a session)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):          # warms the profiler up
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys([*KERNEL_NAMES, "other"], 0)
    for _ in range(sessions):
        with profile(activities=acts) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        seen = dict.fromkeys(counts, 0)
        named: dict = {}
        for e in prof.events():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or "spin_kernel" in e.name):
                continue
            m = re.search(r"\(anonymous namespace\)::(\w+)", e.name)
            owner = next((k for k, names in KERNEL_NAMES.items()
                          if m and m.group(1) in names), "other")
            seen[owner] += 1
            if owner == "other":
                named[e.name] = named.get(e.name, 0) + 1
        counts = {k: max(v, seen[k]) for k, v in counts.items()}
        if others is not None:
            for name, n in named.items():
                others[name] = max(others.get(name, 0), n)
    return counts


def dyn_stage_kernels(model, x) -> tuple[dict, int]:
    """The device kernels of ``model``'s dynamic stages: one eager forward
    on ``x`` recorded (``record_stages``), then each dynamic stage run
    again from its own buffers under ``replay_kernels``, summed by
    wrapper; and the ``quantize_layout`` kernels their calls' plans give
    (``device_kernels``).  What each replay's dynamic stages launch."""
    from repro_torch.kernels.quantize_layout import device_kernels
    execute = importlib.import_module("repro_torch.program.execute")
    _, recs = record_stages(model, x)
    total = dict.fromkeys([*KERNEL_NAMES, "other"], 0)
    want = 0
    for (op, posts), rec in zip(model.program.stages(), recs):
        if op.kind != "dyn_gemm":
            continue
        kern = replay_kernels(lambda: execute._dyn_stage(
            op, posts, rec["bufs"], model.program.cfg, **rec["kw"]))
        for k in total:
            total[k] += kern[k]
        want += sum(device_kernels(xin, K, **kw)
                    for xin, K, kw, _ in rec["quants"])
    return total, want


def aten_ops(fn) -> dict:
    """PyTorch ops (``aten`` overload packets) one call of ``fn`` dispatches,
    counted by name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.ops


# PyTorch ops of a requant factor (``dequant_scale``: two ``clamp_min``,
# two ``mul``) that the static stages must not dispatch on the card
SCALE_OPS = ("clamp_min", "clamp", "mul", "maximum")


def tapped_stages(model, x) -> list[tuple]:
    """Each static stage of one eager forward of ``model`` on ``x`` whose
    epilogue stores a tap (``CrossbarProgram.taps``), its ``fb_epilogue``
    call made again from the recorded operands: the tap ``torch.equal``
    to ``fb_epilogue_ref``'s, the normalized rows ``torch.equal`` to the
    call without a tap and within ``FB_CASES``' layer-norm tolerance of
    the plain version's.  Returns (layer, M, N, kernel launches of the
    tapped call) a stage."""
    import torch
    from repro_torch.kernels import fb_epilogue, fb_epilogue_ref
    from repro_torch.kernels.fb_epilogue import split_outputs
    atol = next(c[3] for c in FB_CASES if c[0] == "layer")
    _, recs = record_stages(model, x)
    out = []
    for (gemm, _), rec in zip(model.program.stages(), recs):
        if not rec.get("fb", (None, {}))[1].get("tap"):
            continue
        got, kw = rec["fb"]
        tap = rec["fb_tap"]
        y, args = rec["fb_in"]
        plain = {k: v for k, v in kw.items() if k not in ("tap", "partials")}
        before = launches_of(fb_epilogue)
        again, again_tap, _ = split_outputs(
            fb_epilogue(y, *args, **kw), tap=True,
            partials=kw.get("partials", False))
        launched = launches_of(fb_epilogue) - before
        untapped = fb_epilogue(y, *args, **plain)
        ref, ref_tap = fb_epilogue_ref(y, *args, **dict(plain, tap=True))
        torch.cuda.synchronize()
        check(torch.equal(again, got) and torch.equal(again_tap, tap),
              f"{gemm.name}: the tapped epilogue differs from its own "
              "call in the forward")
        check(torch.equal(tap, ref_tap), f"{gemm.name}: the tap differs "
              "from the plain path's")
        check(torch.equal(got, untapped), f"{gemm.name}: the normalized "
              "rows differ from the call without a tap")
        err = (got - ref).abs().max().item()
        check(err <= atol, f"{gemm.name}: the normalized rows are {err} "
              f"from the plain path's (tolerance {atol})")
        out.append((gemm.name, *y.shape[-2:], launched))
    return out


def static_stage_ops(model, x) -> dict:
    """``SCALE_OPS`` that the static stages of one eager forward of
    ``model`` on ``x`` dispatch (``aten_ops`` around each
    ``_static_stage``), with the dynamic stages' own scale products left
    out; empty when the kernel writes every requant factor."""
    from repro_torch.program.execute import execute_packed
    execute = importlib.import_module("repro_torch.program.execute")
    real, seen = execute._static_stage, {}

    def counted_stage(*args, **kw):
        out = []
        ops = aten_ops(lambda: out.append(real(*args, **kw)))
        for name in SCALE_OPS:
            if ops.get(name):
                seen[name] = seen.get(name, 0) + ops[name]
        return out[0]

    execute._static_stage = counted_stage
    try:
        execute_packed(model.packed, x, return_logits=True)
    finally:
        execute._static_stage = real
    return seen


def quant_kernels(model, x) -> int:
    """The ``quantize_layout`` device kernels of one eager forward of
    ``model`` on ``x``: each stage's call's ``device_kernels``."""
    from repro_torch.kernels.quantize_layout import device_kernels
    _, recs = record_stages(model, x)
    return sum(device_kernels(xin, K, **kw)
               for r in recs for xin, K, kw, _ in r["quants"])


def executable_phase(api, dev) -> dict:
    """Phase 27: ``EXEC_NETS`` compiled afresh on the card at every
    ``EXEC_BATCHES`` x (probs, logits), the token-input graph at
    ``EXEC_TOKENS``, ``make_server("resnet18")`` and a saved and loaded
    ResNet-18, each held by ``hold_replays``; one b16 replay of each net
    profiled (exactly one ``crossbar_gemm`` and one ``fb_epilogue``
    kernel per stage and ``quant_kernels`` of ``quantize_layout``), each
    tapped epilogue of a b16 forward against the plain path
    (``tapped_stages``), and
    an eager b16 forward's static stages dispatching no PyTorch op of a
    scale (``SCALE_OPS``: ``dequant_scale``'s, which the kernel's requant
    factor replaced; a replay runs what eager launched); time per batch
    at ``EXEC_TIMED`` through ``run``
    (replay) beside eager ``execute_packed``, each with device busy time
    and idle share (``wall_ms``, ``forward_profile``); the capture
    seconds of every key."""
    import tempfile
    import torch
    from repro_torch.program.serve import make_server
    t0 = time.perf_counter()
    for wrapper, names in KERNEL_NAMES.items():
        with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                               f"{wrapper}.cu")) as f:
            source = f.read()
        check(all(re.search(rf"\b{n}\(", source) for n in names),
              f"KERNEL_NAMES[{wrapper!r}] names a kernel {wrapper}.cu "
              "does not define")
    gen = torch.Generator(device=dev).manual_seed(27)
    out = dict(nets={}, launches=each(0), keys=0)

    def held(name, model, answer, shapes, flavors=(False, True)):
        r = hold_replays(name, model, answer, shapes, flavors, gen)
        for k in out["launches"]:
            out["launches"][k] += r["launches"][k]
        out["keys"] += len(r["capture_s"])
        detail(f"27 {name} capture s per key: " + ", ".join(
            f"{k[0]}/{'logits' if k[1] else 'probs'}/{k[2]} {s:.3f}"
            for k, s in r["capture_s"].items()))
        return r

    models = {}
    for net, kw in EXEC_NETS:
        name = net + ("-adc8" if kw else "")
        model = models[name] = api.compile(net, api.HurryConfig(**kw),
                                           seed=0, device="cuda")
        r = held(name, model, lambda x, lg, m=model: m.run(x, logits=lg),
                 [model.program.input_shape(b) for b in EXEC_BATCHES])
        n = len(model.program.stages())
        n_dyn = sum(g.kind == "dyn_gemm" for g, _ in model.program.stages())
        x16 = torch.randn(model.program.input_shape(16), generator=gen,
                          device=dev)
        others: dict = {}
        kern = replay_kernels(lambda: model.run(x16), others=others)
        quant = quant_kernels(model, x16)
        scale_ops = static_stage_ops(model, x16)
        check(kern["crossbar_gemm"] == n and kern["fb_epilogue"] == n
              and kern["quantize_layout"] == quant,
              f"{name} b16: one replay ran {kern} kernels for {n} stages "
              "(one crossbar_gemm and fb_epilogue kernel per stage, "
              f"{quant} quantize_layout kernels by device_kernels)")
        for k_name, k_n in sorted(others.items()):
            detail(f"27 {name} b16 replay, other kernel: {k_name} x {k_n}")
        dyn = None
        if n_dyn:         # the dynamic stages launch the wrappers' only
            dyn, want_q = dyn_stage_kernels(model, x16)
            check(dyn == dict(crossbar_gemm=n_dyn, fb_epilogue=n_dyn,
                              quantize_layout=want_q, other=0),
                  f"{name} b16: the {n_dyn} dynamic stages ran {dyn} "
                  f"kernels, expected one crossbar_gemm and fb_epilogue "
                  f"each, {want_q} quantize_layout and no other")
        check(not scale_ops, f"{name} b16: the static stages dispatched "
              f"{scale_ops}: a requant factor computed by PyTorch")
        taps = tapped_stages(model, x16)
        check(len(taps) == len(model.program.taps())
              and all(t[3] == 1 for t in taps),
              f"{name} b16: {len(taps)} tapped epilogue calls for "
              f"{len(model.program.taps())} taps, launches {taps}")
        for t in taps:
            detail(f"27 {name} b16 tapped epilogue {t[0]}: M={t[1]} "
                   f"N={t[2]}, one launch, the tap torch.equal to the "
                   "plain path")
        times = {}
        for b in EXEC_TIMED:
            xb = x16[:b].contiguous()
            times[b] = {}
            for mode, fn in (("replay", lambda: model.run(xb)),
                             ("eager", lambda: eager_run(model, xb))):
                ms = wall_ms(fn)
                busy, top = forward_profile(fn, top=None)
                times[b][mode] = dict(ms=ms, busy=busy,
                                      by_wrapper=busy_by_wrapper(top))
                for k_ms, k_n, k_name in top[:12]:
                    detail(f"27 {name} b{b} {mode} kernel {k_name}: "
                           f"{k_ms:.4f} ms in {k_n} launches")
        caps = sorted(r["capture_s"].values())
        out["nets"][name] = dict(stages=n, kernels=kern, times=times,
                                 others=others, dyn=dyn, taps=len(taps),
                                 capture=(caps[0], statistics.median(caps),
                                          caps[-1]))
    tok = api.compile(token_graph(api), api.HurryConfig(), seed=0,
                      device="cuda")
    r = held("tokens", tok, lambda x, lg: tok.run(x, logits=lg),
             [tok.program.input_shape(b, seq_len=T) for T in EXEC_TOKENS
              for b in EXEC_BATCHES])
    check(len(tok._fns) == 2 * len(EXEC_TOKENS) * len(EXEC_BATCHES),
          f"token graph: {len(tok._fns)} executables")
    resnet = models["resnet18"]
    server = make_server("resnet18", config=api.HurryConfig(), seed=0,
                         device="cuda")
    held("server", server, lambda x, lg: server(x),
         [server.program.input_shape(b) for b in EXEC_BATCHES],
         flavors=(False,))
    with tempfile.TemporaryDirectory() as d:
        loaded = api.load(resnet.save(os.path.join(d, "resnet18.npz")),
                          device="cuda")
    check(not loaded._fns, "a loaded model starts with executables")
    held("loaded", loaded, lambda x, lg: loaded.run(x, logits=lg),
         [loaded.program.input_shape(b) for b in EXEC_BATCHES])
    out["s"] = time.perf_counter() - t0
    return out


def executable_line(xp: dict, card: str) -> str:
    """Phase 27's line on standard output."""
    def busy(t):
        return ("busy not measured" if t["busy"] is None else
                f"busy {t['busy']:.3f} ms, idle {1 - t['busy'] / t['ms']:.1%}")
    def by(t):
        return "/".join(f"{v:.3f}" for v in t["by_wrapper"].values())

    def named(r):
        return ", ".join(f"{k[:60]} x{n}"
                         for k, n in sorted(r["others"].items()))

    nets = "; ".join(
        f"{name} ({r['stages']} stages; one b16 replay's kernels "
        f"{r['kernels']}, the other ones {named(r) or 'none'}"
        + (f"; its dynamic stages run again alone: {r['dyn']}" if r["dyn"]
           else "")
        + (f"; its {r['taps']} tapped epilogues again from their operands: "
           "the tap torch.equal to the plain path, the rows to the "
           "untapped call" if r["taps"] else "")
        + f"; capture s min/median/max {r['capture'][0]:.3f}/"
        f"{r['capture'][1]:.3f}/{r['capture'][2]:.3f}): " + ", ".join(
            f"b{b} replay {t['replay']['ms']:.3f} ms ({busy(t['replay'])}; "
            f"{'/'.join(KERNEL_NAMES)}/other {by(t['replay'])} ms) vs eager "
            f"{t['eager']['ms']:.3f} ms ({busy(t['eager'])})"
            for b, t in r["times"].items())
        for name, r in xp["nets"].items())
    return (f"[27 executable per bucket] {xp['keys']} keys captured "
            f"({'/'.join(xp['nets'])} at b{','.join(map(str, EXEC_BATCHES))}"
            f" x (probs, logits) through run, the token graph at T "
            f"{'/'.join(map(str, EXEC_TOKENS))}, make_server(resnet18), a "
            "loaded resnet18): every replay torch.equal to eager "
            "execute_packed on the card on two draws, both answers kept; "
            f"launches {xp['launches']} = one per stage for each request "
            "and key warm-up; "
            f"{nets} (host clock + synchronize, median of 10); phase "
            f"{xp['s']:.1f} s | {card}")


# phase 29: the nets driven eagerly at QUANT_BATCHES (default widths), and
# at every WIDTHS row the nets of phase 25 at their batches; ResNet-18's
# calls timed at each of QUANT_BATCHES
QUANT_BATCHES = (1, 3, 16)
QUANT_WIDTH_NETS = (("resnet18", 16), ("alexnet", 4), ("vit_tiny", 16))


def quant_covered(xin, kw) -> int:
    """Elements of ``xin`` that a ``quantize_layout`` call must read: the
    pixels some patch reads (a conv), or all of them."""
    from repro_torch.kernels.quantize_layout import covered
    if kw.get("conv") is None:
        return xin.numel()
    n, h, w, c = xin.shape

    def count(size):
        return sum(len(range(size)[sl]) for sl in covered(size, *kw["conv"]))
    return n * count(h) * count(w) * c


def quant_bound(xin, kw, got) -> float:
    """The least time of one call on the card, in ms: the covered input
    (and the weight amaxes) read once (float32), the int8 operand, the
    amaxes and the requant factors written once, over the memory rate (its
    few operations an element are far below the float32 rate)."""
    x8, amax = got[:2]
    moved = (4 * quant_covered(xin, kw) + x8.numel() + 4 * amax.numel()
             + (8 * got[2].numel() if len(got) == 3 else 0))
    return moved / HBM_BYTES_PER_S * 1e3


def old_chain(xin, K: int, kw: dict):
    """An operand as the port made it before the kernel: ``im2col``,
    ``abs``, ``amax``, the scale, the division, ``round``, the clamp, the
    int8 cast and ``kernel_layout``'s pad, each a PyTorch kernel (one
    tensor-wide amax, or per slice: a dynamic stage's, the right operand
    as ``plane_pack`` made it), and where the call asks for it
    ``dequant_scale``'s four scalar kernels, or per slice the product of
    the two ``quantize_scale``s."""
    import torch
    from repro_torch.core.crossbar import (dequant_scale, quantize_scale,
                                           quantize_with_scale)
    from repro_torch.kernels import kernel_layout
    from repro_torch.program.execute import im2col
    if kw.get("conv") is not None:
        cols = im2col(xin, *kw["conv"])
        xin = cols.reshape(-1, cols.shape[-1])
    per_slice = kw.get("per_slice", False)
    amax = xin.abs().amax(dim=(-2, -1)) if per_slice else xin.abs().amax()
    scale = quantize_scale(amax, kw["bits"])
    q = quantize_with_scale(xin, scale[..., None, None] if per_slice
                            else scale, kw["bits"]).to(torch.int8)
    out = (kernel_layout(q, K, rows=kw["rows"],
                         adc_bits=kw["adc_bits"]).contiguous(), amax)
    if kw.get("w_amax") is None:
        return out
    if per_slice:
        return (*out, (scale * quantize_scale(
            kw["w_amax"].reshape(amax.shape), kw["weight_bits"])
        ).reshape(-1, 1, 1))
    return (*out, dequant_scale(amax, kw["w_amax"], kw["bits"],
                                kw["weight_bits"]).reshape(1, 1))


def near_ties(shape, gen, bits: int = 8, amax: float = 3.0):
    """Values (k + 1/2) * scale on the card for integers -qmax <= k < qmax,
    and one of |x| = ``amax`` (so that scale is ``quantize_scale(amax)``):
    each x / scale within an ulp or so of a half-integer, where the
    kernel's multiply by 1/scale leaves the decision to the true
    division."""
    import torch
    from repro_torch.kernels.quantize_layout import qmax, quantize_scale
    s = quantize_scale(torch.tensor(amax), bits).item()
    k = torch.randint(-qmax(bits), qmax(bits), shape, generator=gen,
                      device=gen.device)
    x = ((k + 0.5) * s).float()
    x.view(-1)[0] = amax
    return x


# phase 29's near-tie inputs: (shape, quantize_layout kwargs, K, view):
# view "v-heads" reads the input as a (B, T, 3D) fused projection's V
# heads transposed (B, 3, hd, T), a stride of 3D along k: a dynamic
# stage's right operand, here at 4 bits on the sliced branch, every
# slice holding its own amax
QUANT_TIES = (((64, 1000), dict(rows=494), 1482, None),
              ((2, 16, 16, 8), dict(conv=(3, 1, 1)), 494, None),
              ((48, 64, 64), dict(rows=64, per_slice=True, bits=4), 64, None),
              ((16, 64, 576), dict(rows=64, adc_bits=6, per_slice=True,
                                   bits=4), 64, "v-heads"))


def _forced(qmod, one_launch: bool | None):
    """A context that forces ``quantize_layout``'s path (None: the
    wrapper's own choice) through ``ONE_LAUNCH_MAX``."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = qmod.ONE_LAUNCH_MAX
        if one_launch is not None:
            qmod.ONE_LAUNCH_MAX = 2 ** 31 if one_launch else -1
        try:
            yield
        finally:
            qmod.ONE_LAUNCH_MAX = saved
    return ctx()


def quant_times(calls, label: str, paths: bool = True) -> dict:
    """Device ms of a forward's ``quantize_layout`` calls (the executor's
    own, as ``record_stages`` recorded them), summed: the kernel, the
    plain version, the PyTorch chain it replaced (``old_chain``, held
    equal), the bound; with ``paths`` also every call with the one-launch
    and the multi-pass path forced (reducing its own amax: a call given
    partial maxima is timed without them there).  Per call on standard
    error."""
    import torch
    from repro_torch.kernels import quantize_layout
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    t = dict(ms=0.0, plain=0.0, chain=0.0, bound=0.0, one=0.0, multi=0.0,
             largest=None)
    for xin, K, qkw, got in calls:
        chain = old_chain(xin, K, qkw)
        check(len(chain) == len(got) and all(
            torch.equal(a, b) for a, b in zip(chain, got)),
            f"29 {label}: the kernel differs from the chain it replaced")
        c = dict(ms=device_ms(lambda: quantize_layout(xin, K, **qkw)),
                 plain=device_ms(lambda: qmod.quantize_layout_ref(
                     xin, K, **qkw)),
                 chain=device_ms(lambda: old_chain(xin, K, qkw)),
                 bound=quant_bound(xin, qkw, got))
        own = {k: v for k, v in qkw.items() if k != "partials"}
        if paths:
            for key, one in (("one", True), ("multi", False)):
                with _forced(qmod, one):
                    c[key] = device_ms(lambda: quantize_layout(xin, K, **own))
        geo = {k: v for k, v in qkw.items()
               if k in ("rows", "adc_bits", "conv", "per_slice")}
        if "partials" in qkw:
            geo["partials"] = qkw["partials"].numel()
        pl = qmod.plan(xin, K, **geo)
        covered = quant_covered(xin, qkw)
        detail(f"time 29 {label} quantize_layout {tuple(xin.shape)} K={K} "
               f"{geo} covered {covered}: kernel {c['ms']:.4f} ms "
               f"({'one launch' if pl.one_launch else 'multi-pass'}, "
               f"{pl.kernels} kernels; bound {c['bound']:.5f}, plain "
               f"{c['plain']:.4f}, old chain {c['chain']:.4f}"
               + (f"; forced one-launch {c['one']:.4f}, multi-pass "
                  f"{c['multi']:.4f}" if paths else "") + ")")
        for k in c:
            t[k] += c[k]
        if t["largest"] is None or covered > t["largest"][0]:
            t["largest"] = (covered, tuple(xin.shape), c["ms"], c["bound"])
    t["launches"] = len(calls)
    return t


def quantize_phase(api, dev) -> dict:
    """Phase 29: ``quantize_layout`` on the executor's path.  ``EXEC_NETS``
    at ``QUANT_BATCHES`` and ``QUANT_WIDTH_NETS`` at every ``WIDTHS`` row,
    each compiled on the card and driven eagerly through ``execute_packed``
    (``record_stages``): one ``quantize_layout`` launch per stage, static
    and dynamic, each call's (x8, amax) and each static stage's requant
    factor ``torch.equal`` to the plain version on the same card tensors
    (``given``: the calls that took the partial maxima their input's
    epilogue left, in place of an amax pass; some must), and no card
    tensor reaching the plain version (a spy on
    ``quantize_layout_ref``).  Then per ResNet-18 forward at b16, b3 and
    b1, over its stages: the device kernels of all its calls in one
    profile (exactly ``device_kernels``, nothing else: no memset, no
    scalar kernel), and ``quant_times``.  Also ``QUANT_TIES``: inputs
    whose every x / scale lies within an ulp of a half-integer, on both
    paths."""
    import torch
    from repro_torch.kernels import quantize_layout
    from repro_torch.kernels.quantize_layout import device_kernels
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    ref = qmod.quantize_layout_ref
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(29)
    ref_devices: list = []

    def ref_spy(x, *args, **kw):
        ref_devices.append(x.device.type)
        return ref(x, *args, **kw)

    runs = [(net + ("-adc8" if kw else ""), net, kw, b)
            for net, kw in EXEC_NETS for b in QUANT_BATCHES]
    runs += [(f"{net}-{w}", net, WIDTHS[w], b)
             for net, b in QUANT_WIDTH_NETS for w in WIDTHS]
    out = dict(calls=0, err=0, runs=len(runs), recs={}, static=0, dyn=0,
               requant=0, given=0)
    qmod.quantize_layout_ref = ref_spy
    try:
        for label, net, kw, b in runs:
            model = api.compile(net, api.HurryConfig(**kw), seed=0,
                                device="cuda")
            stages = model.program.stages()
            x = torch.randn(model.program.input_shape(b), generator=gen,
                            device=dev)
            (_, recs), n = counted(lambda: record_stages(model, x))
            n_dyn = sum(g.kind == "dyn_gemm" for g, _ in stages)
            per_stage = [2 if g.kind == "dyn_gemm" else 1 for g, _ in stages]
            check(n["quantize_layout"] == len(stages) + n_dyn
                  and [len(r["quants"]) for r in recs] == per_stage,
                  f"29 {label} b{b}: {n['quantize_layout']} quantize_layout "
                  f"launches for {len(stages)} stages ({n_dyn} dynamic, "
                  "two each)")
            check("cuda" not in ref_devices, f"29 {label}: the plain "
                  "version ran on a card tensor from execute_packed")
            for r in recs:                   # the right operand's amax
                if len(r["quants"]) == 2:    # is the left one's w_amax
                    right, left = r["quants"]
                    check(left[2].get("w_amax") is right[3][1]
                          and left[2].get("per_slice") and len(left[3]) == 3,
                          f"29 {label} b{b}: a dynamic stage's left operand "
                          "took no requant factor from its right operand")
            with_requant = 0
            for xin, K, qkw, got in (q for r in recs for q in r["quants"]):
                want = ref(xin, K, **qkw)
                check(len(got) == len(want) and all(
                    a.shape == w.shape for a, w in zip(got, want)),
                      f"29 {label} b{b}: a quantize_layout call {qkw} "
                      f"returned shapes {[a.shape for a in got]}, the plain "
                      f"version {[w.shape for w in want]}")
                out["err"] = max(out["err"], int(
                    (got[0].int() - want[0].int()).abs().max()))
                check(all(torch.equal(a, w) for a, w in zip(got, want)),
                      f"29 {label} b{b}: a quantize_layout call {qkw} "
                      f"differs from the plain version")
                with_requant += len(got) == 3
                out["given"] += "partials" in qkw
            check(with_requant == len(stages),
                  f"29 {label} b{b}: {with_requant} calls wrote the requant "
                  f"factor, for {len(stages)} stages")
            out["calls"] += n["quantize_layout"]
            out["requant"] += with_requant
            out["static"] += len(stages) - n_dyn
            out["dyn"] += n_dyn
            if label == "resnet18":
                out["recs"][b] = [q for r in recs for q in r["quants"]]
            if label == "vit_tiny" and b == 16:
                out["dyn_calls"] = [q for r in recs if len(r["quants"]) == 2
                                    for q in r["quants"]]
    finally:
        qmod.quantize_layout_ref = ref
    check(out["given"] > 0, "29: no call took the partial maxima of its "
          "input's epilogue")
    tie_gen = torch.Generator(device=dev).manual_seed(30)
    for shape, kw, K, view in QUANT_TIES:
        amax = 3.0
        x = near_ties(shape, tie_gen, bits=kw.get("bits", 8), amax=amax)
        if view == "v-heads":
            from repro_torch.program.sequence import qkv_head_views
            x = qkv_head_views(x, 3)[2].mT
            x[..., 0, 0] = amax              # every slice's scale the same
        want = ref(x, K, **kw)
        for one in (True, False):
            with _forced(qmod, one):
                got = quantize_layout(x, K, **kw)
            check(all(torch.equal(a, w) for a, w in zip(got, want)),
                  f"29 near ties {shape} {kw} (one launch {one}): the "
                  "kernel differs from the plain version")
    times = {}
    for b, calls in sorted(out.pop("recs").items(), reverse=True):
        def all_calls(calls=calls):
            for xin, K, qkw, _ in calls:
                quantize_layout(xin, K, **qkw)
        kern = replay_kernels(all_calls)
        want = sum(device_kernels(xin, K, **qkw)
                   for xin, K, qkw, _ in calls)
        check(kern["quantize_layout"] == want and sum(kern.values()) == want,
              f"29 resnet18 b{b}: the {len(calls)} calls ran {kern} device "
              f"kernels, device_kernels says {want} of their own")
        times[b] = quant_times(calls, f"resnet18 b{b}")
        times[b]["kernels"] = want
    out["times"] = times
    # vit_tiny b16's dynamic stages: the right operands, then the left
    # ones (each with the requant factor), as one profile and as timed
    dyn = out.pop("dyn_calls")
    kern = replay_kernels(lambda: [quantize_layout(xin, K, **qkw)
                                   for xin, K, qkw, _ in dyn])
    want = sum(device_kernels(xin, K, **qkw) for xin, K, qkw, _ in dyn)
    check(kern["quantize_layout"] == want and sum(kern.values()) == want,
          f"29 vit_tiny b16 dynamic stages: the {len(dyn)} calls ran {kern} "
          f"device kernels, device_kernels says {want} of their own")
    out["vit_dyn"] = {side: quant_times(dyn[i::2], f"vit_tiny b16 {side}",
                                        paths=False)
                      for i, side in enumerate(("right", "left"))}
    out["vit_dyn"]["kernels"] = want
    out["s"] = time.perf_counter() - t0
    return out


def quantize_line(qp: dict, card: str) -> str:
    """Phase 29's line on standard output."""
    t = "; ".join(
        f"per ResNet-18 b{b} forward ({r['launches']} calls, {r['kernels']} "
        f"device kernels): kernel {r['ms']:.4f} ms (bound {r['bound']:.5f} "
        f"by bytes, plain {r['plain']:.4f}, the replaced chain "
        f"{r['chain']:.4f}; every call forced to one launch (1x1 convs "
        f"multi-pass) {r['one']:.4f}, to the multi-pass path "
        f"{r['multi']:.4f}); its largest stage "
        f"{r['largest'][1]} {r['largest'][2]:.4f} ms (bound "
        f"{r['largest'][3]:.5f})"
        for b, r in qp["times"].items())
    v = qp["vit_dyn"]
    dyn = "; ".join(
        f"its {r['launches']} {side}-operand calls {r['ms']:.4f} ms (bound "
        f"{r['bound']:.5f} by bytes, plain {r['plain']:.4f}, the replaced "
        f"PyTorch chain {r['chain']:.4f})" for side, r in
        (("right", v["right"]), ("left", v["left"])))
    return (f"[29 quantize_layout] {qp['runs']} eager forwards "
            f"({'/'.join(n + ('-adc8' if kw else '') for n, kw in EXEC_NETS)}"
            f" at b{','.join(map(str, QUANT_BATCHES))}; "
            f"{'/'.join(n for n, _ in QUANT_WIDTH_NETS)} at "
            f"{'/'.join(WIDTHS)}): one launch per static stage and two per "
            f"dynamic stage, {qp['calls']} calls ({qp['static']} static, "
            f"{qp['dyn']} dynamic stages) each torch.equal to the plain "
            "version (x8 and amax, and the requant factor of all "
            f"{qp['requant']} stages: the static ones, and the dynamic ones' "
            "per-slice plain product from their right operand's amax), none "
            "of the plain version on a card tensor from execute_packed, "
            f"{len(QUANT_TIES)} near-tie inputs equal on both paths; "
            f"{t}; per vit_tiny b16 forward's dynamic stages ({v['kernels']} "
            f"device kernels): {dyn}; phase {qp['s']:.1f} s | {card}")


def kernel_times(label: str) -> int:
    """``--kernel-times``: the times of phases 7, 15 and 29 that compare
    the redesigned kernels with another tree, for the ``repro_torch`` on
    ``sys.path``: ``fb_epilogue`` per ResNet-18 b16 forward and at
    vit_tiny's dynamic pairs, ``flash_attention`` on the attention path
    and at ``FLASH_TIMED`` beside SDPA, ``fused_gemm_epilogue`` and
    ``packed_gemm`` at ``FUSED_TIMED`` / ``PACKED_TIMED``
    (``float_gemm_times``), and ``quantize_layout`` per ResNet-18 b16 and
    b1 forward (the calls that tree's executor makes, ``record_stages``).
    The last line is a JSON record."""
    import torch
    import repro_torch
    from repro_torch import api
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    log(nvidia_smi())
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.build, _build.SOURCES))
    log(f"[times {label}] repro_torch from "
        f"{os.path.dirname(os.path.dirname(repro_torch.__file__))}")
    resnet = api.compile("resnet18", api.HurryConfig(), seed=0,
                         device="cuda")
    f = fb_stage_times(stage_shapes(resnet, 16), dev, gen)
    dyn = dyn_fb_times(dev, gen)
    flt = flash_times(dev, gen)
    fg = float_gemm_times(dev, gen)
    ql = importlib.import_module(
        "repro_torch.kernels.quantize_layout").quantize_layout
    quant = {}
    for b in (16, 1):
        x = torch.randn(resnet.program.input_shape(b), generator=gen,
                        device=dev)
        calls = [q for r in record_stages(resnet, x)[1] for q in r["quants"]]
        quant[f"resnet18_b{b}"] = dict(
            ms=sum(device_ms(lambda: ql(xin, K, **kw))
                   for xin, K, kw, _ in calls),
            bound_ms=sum(quant_bound(xin, kw, got)
                         for xin, K, kw, got in calls),
            calls=len(calls), requant=sum(len(got) == 3
                                          for _, _, _, got in calls))
    rec = dict(label=label, quantize_layout=quant, fb_resnet18_b16=dict(
        ms=f["ms"], bound_ms=f["bound"], plain_ms=f["plain"],
        launches=len(f["stages"])),
        fb_vit_dyn_pair=dict(ms=dyn["ms"], bound_ms=dyn["bound"],
                             plain_ms=dyn["plain"]),
        flash_attention_path=dict(ms=flt["path"]["ms"],
                                  sdpa_ms=flt["path"]["lib"],
                                  plain_ms=flt["path"]["plain"]),
        flash_attention=flt["shapes"], fused_gemm_epilogue=fg["fused"],
        packed_gemm=fg["packed"])
    fu, pk = fg["fused"][0], fg["packed"][0]
    log(f"[times {label}] quantize_layout per ResNet-18 forward "
        + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.5f}, "
                    f"{v['calls']} calls, {v['requant']} writing the requant "
                    "factor)" for k, v in quant.items()))
    log(f"[times {label}] fb_epilogue ResNet-18 b16 {f['ms']:.4f} ms (bound "
        f"{f['bound']:.4f}); vit_tiny dynamic pair {dyn['ms']:.4f} ms; "
        f"flash_attention path {flt['path']['ms']:.4f} ms; "
        f"fused_gemm_epilogue 256x512x256 silu float32 {fu['ms']:.4f} ms; "
        f"packed_gemm 4 groups float32 {pk['ms']:.4f} ms")
    print(json.dumps(rec))
    return 0


# ---------------------------------------------------------------------------
# phase 28: the compiled decode step's cases that 21, 24 and 26 do not reach
# ---------------------------------------------------------------------------

DECODE_RINGS = ("mixtral_8x22b", "zamba2_2_7b")   # (a), window cut to 8
DECODE_CASES = dict(batch=2, window=8, steps=24, mid=5)


def decode_cases_phase(dev) -> dict:
    """Phase 28: ``compile_decode_step`` at ``reduced()`` on the card,
    bfloat16 weights, batch 2, positions alternately ints and 0-d
    tensors: (a) ``DECODE_RINGS`` with the window cut to 8, decoded 24
    steps (three times round the ring) beside the eager step, every
    step's ids and logits and the last caches ``torch.equal``; (b) a
    second params tree of the same shapes (another draw) gets a key of
    its own, each answer ``torch.equal`` to the eager step on its own
    tree, the first key replays on; (c) a foreign cache tree (an eager
    loop's after ``mid`` steps) is copied in, and the replays go on from
    it equal to the eager step; (d) a call under a sharding context with
    a mesh raises and captures nothing.  No launch of the six kernels."""
    import dataclasses
    import types
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.step import compile_decode_step, make_decode_step
    from repro_torch.sharding import context as shctx
    t0, before = time.perf_counter(), _launch_counts()
    B, steps = DECODE_CASES["batch"], DECODE_CASES["steps"]

    def setup(arch, seed, **kw):
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        gen = torch.Generator(dev).manual_seed(seed)
        params = lm.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (B, steps), generator=gen,
                               device=dev, dtype=torch.int32)
        return cfg, params, tokens

    def position(i):
        return i if i % 2 else torch.tensor(i, dtype=torch.int32, device=dev)

    def lockstep(cfg, params, tokens, compiled, caches, start=0, stop=steps,
                 eager_caches=None):
        """Teacher-forced steps ``start``..``stop`` through both steps;
        True when every answer and the last caches are equal."""
        eager = make_decode_step(cfg)
        ce, same = caches if eager_caches is None else eager_caches, True
        for i in range(start, stop):
            tok = tokens[:, i:i + 1]
            n_e, l_e, ce = eager(params, tok, ce, position(i))
            n_c, l_c, caches = compiled(params, tok, caches, position(i))
            same &= torch.equal(n_e, n_c) and torch.equal(l_e, l_c)
        return same and all(torch.equal(a, b) for a, b in zip(
            _tree_leaves(ce), _tree_leaves(caches))), ce, caches

    out = dict(rings={}, capture_s=[])
    for i, arch in enumerate(DECODE_RINGS):
        cfg, params, tokens = setup(arch, 280 + i,
                                    sliding_window=DECODE_CASES["window"])
        compiled = compile_decode_step(cfg)
        init = lm.init_caches(cfg, B, steps, params=params)
        same, _, caches = lockstep(cfg, params, tokens, compiled, init)
        (exe,) = compiled.executables.values()
        out["capture_s"].append(exe.capture_s)
        index = int(caches["kv"]["index"][0])
        check(same and index == steps
              and caches["kv"]["k"].shape[2] == DECODE_CASES["window"],
              f"28a {arch}: ring of {DECODE_CASES['window']} over {steps} "
              f"steps: replay equal to eager {same}, index {index}")
        out["rings"][arch] = dict(index=index,
                                  wraps=index // DECODE_CASES["window"])

    # (b) two params trees of the same shapes
    cfg, params, tokens = setup("qwen3_8b", 290)
    _, other, _ = setup("qwen3_8b", 291)
    compiled, eager = compile_decode_step(cfg), make_decode_step(cfg)
    init = lm.init_caches(cfg, B, steps, params=params)
    answers = []
    for p in (params, other, params):
        _, logits, _ = compiled(p, tokens[:, :1], init, 0)
        answers.append(torch.equal(logits, eager(p, tokens[:, :1], init,
                                                 0)[1]))
    check(all(answers) and len(compiled.executables) == 2,
          f"28b: answers equal to eager {answers}, "
          f"{len(compiled.executables)} keys (expected 2)")
    out["capture_s"] += [e.capture_s for e in compiled.executables.values()]
    out["params_keys"] = len(compiled.executables)

    # (c) a foreign cache tree copied in
    mid = DECODE_CASES["mid"]
    compiled = compile_decode_step(cfg)
    compiled(params, tokens[:, :1], init, 0)          # captures the key
    _, mid_caches, _ = lockstep(cfg, params, tokens, make_decode_step(cfg),
                                init, stop=mid)
    same, _, caches = lockstep(cfg, params, tokens, compiled, mid_caches,
                               start=mid, eager_caches=mid_caches)
    check(same and len(compiled.executables) == 1
          and int(caches["kv"]["index"][0]) == steps,
          f"28c: replays from a foreign cache tree equal to eager {same}")
    out["foreign"] = same

    # (d) a mesh context
    compiled = compile_decode_step(cfg)
    try:
        with shctx.use_rules(types.SimpleNamespace(mesh="mesh")):
            compiled(params, tokens[:, :1], init, 0)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    check(raised is not None and "mesh" in raised
          and not compiled.executables,
          f"28d: a call under a mesh context did not raise ({raised})")
    out["mesh_error"] = raised
    after = _launch_counts()
    out["launched"] = {k: after[k] - before[k] for k in after}
    check(not any(out["launched"].values()),
          f"phase 28 launched kernels of repro_torch.kernels: "
          f"{out['launched']}")
    out["s"] = time.perf_counter() - t0
    return out


def decode_cases_line(dc: dict, card: str) -> str:
    """Phase 28's line on standard output."""
    caps = sorted(dc["capture_s"])
    return ("[28 compiled decode cases] reduced(), bf16, b"
            f"{DECODE_CASES['batch']}: (a) "
            + ", ".join(f"{a} window {DECODE_CASES['window']} to index "
                        f"{r['index']} ({r['wraps']} times round)"
                        for a, r in dc["rings"].items())
            + ": every step's ids and logits and the caches torch.equal to "
            f"the eager step; (b) a second params tree: "
            f"{dc['params_keys']} keys, each answer torch.equal to eager on "
            f"its own tree; (c) a foreign cache tree copied in after "
            f"{DECODE_CASES['mid']} eager steps, replays torch.equal to eager "
            f"{dc['foreign']}; (d) under a mesh context: raised "
            f"RuntimeError, nothing captured; capture s min/median/max "
            f"{caps[0]:.3f}/{statistics.median(caps):.3f}/{caps[-1]:.3f}; "
            f"kernel launches {dc['launched']}; phase {dc['s']:.1f} s | "
            f"{card}")


def main(argv: list[str] | None = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel-times", action="store_true",
                        help="only time the redesigned kernels "
                        "(see kernel_times)")
    parser.add_argument("--src", help="import repro_torch from this "
                        "directory instead of src/ beside the script")
    parser.add_argument("--label", default="tree")
    args = parser.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.kernel_times:
        return kernel_times(args.label)
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.crossbar_gemm import (clip_possible,
                                                   crossbar_gemm,
                                                   crossbar_gemm_exact_ref,
                                                   crossbar_gemm_ref,
                                                   kernel_layout)
    from repro_torch.kernels.fb_epilogue import fb_epilogue

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 1. device + build ------------------------------------------------
    card = nvidia_smi()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.build, _build.SOURCES))
    build_s = time.perf_counter() - t0
    log(card)
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
        f"{build_s:.1f} s")
    for name in _build.SOURCES:
        with open(f"{_build.library_path(name)}.log") as f:
            for ln in f:
                if "registers" in ln or "spill" in ln:
                    detail(f"ptxas {name}: {ln.strip()}")
    sass = sass_opcodes(_build, "crossbar_gemm")
    check(sass is None or (sass["IGMMA"] > 0 and sass["IDP4A"] == 0
                           and sass["POPC"] == 0),
          f"crossbar_gemm's SASS is not on the int8 tensor cores: {sass}")
    # the float GEMMs' products on the tensor cores (mma.sync: HMMA; a
    # wgmma design would show HGMMA)
    float_sass = {name: sass_opcodes(_build, name)
                  for name in ("fused_gemm_epilogue", "packed_gemm")}
    for name, ops_ in float_sass.items():
        check(ops_ is None or ops_["HMMA"] + ops_["HGMMA"] > 0,
              f"{name}'s SASS holds no tensor-core instruction: {ops_}")
    log(f"[1 sass] crossbar_gemm opcodes "
        f"{sass if sass else 'not read (no cuobjdump)'}; "
        + "; ".join(f"{name} {ops_ if ops_ else 'not read'}"
                    for name, ops_ in float_sass.items()))

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    # shapes of the main path: ResNet-18, default config, batch 16
    resnet_gpu = api.compile("resnet18", api.HurryConfig(), seed=0,
                             device="cuda")
    shapes = stage_shapes(resnet_gpu, 16)

    # -- 2. crossbar_gemm, exact branch ----------------------------------
    gemm_err, n_exact, ex_splits = gemm_exact_phase(dev, gen, shapes)
    wide = wide_phase(gen)
    torch.cuda.synchronize()
    log(f"[2 crossbar_gemm exact] {n_exact} cases equal to the plain version "
        f"(torch.equal): ResNet-18 b16 stages through the mounted wt, ragged "
        f"and edge shapes (M 1/4/16 x K {'/'.join(map(str, EDGE_K))} x N "
        f"{'/'.join(map(str, EDGE_N))}), all -128, K split {ex_splits} and 1;"
        f" wide tiles {wide['cases']} cases (bn "
        f"{'/'.join(str(c[3]) for c in WIDE_CASES)}) in {wide['launches']} "
        f"launches, equal")

    # -- 3. crossbar_gemm, sliced branch ---------------------------------
    sliced_err, n_sliced, clipped, sl_splits = gemm_sliced_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[3 crossbar_gemm sliced] {n_sliced} cases equal to the plain "
        f"version, ADC clips fired in {clipped} (every case where rows > "
        f"2^adc_bits - 1); rows {'/'.join(map(str, EDGE_ROWS))} x M 1/4/16, "
        f"all -1, chunk split {sl_splits} and 1")

    # -- 4. fb_epilogue, every mode --------------------------------------
    fb_err, parts, n_fb = fb_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[4 fb_epilogue] {n_fb} cases (every mode at N "
        f"{'/'.join(map(str, FB_WIDTHS))} and its own width, the row modes "
        f"also at {'/'.join(map(str, FB_ROW_WIDTHS))}); max |kernel - plain| "
        "per mode: " + ", ".join(parts))

    # -- 5. the main path: ResNet-18 serving requests --------------------
    resnet_cpu = api.compile("resnet18", api.HurryConfig(), seed=0,
                             device="cpu")
    n_stages = len(resnet_gpu.program.stages())
    rng = np.random.default_rng(0)
    requests = [rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
                for b in (1, 3, 16)]
    served, main_launches = counted(
        lambda: [(resnet_gpu.run(x), resnet_gpu.run(x, logits=True))
                 for x in requests])
    want = n_stages * 4 * len(requests)     # each run its key's first
    check(main_launches == each(want),
          f"launch counts {main_launches}, expected {want} each "
          f"({n_stages} stages x {2 * len(requests)} runs, each a key's "
          "warm-up and its replay)")
    worst_rel, agree, exact = 0.0, [], True
    for x, (probs, logits) in zip(requests, served):
        ref_logits = resnet_cpu.run(x, logits=True)
        ref_probs = resnet_cpu.run(x)
        got = logits.cpu()
        check(got.shape == (x.shape[0], 10) and bool(torch.isfinite(got).all())
              and bool(torch.isfinite(probs).all()), "non-finite output")
        check(bool(torch.allclose(probs.sum(1).cpu(), torch.ones(len(x)),
                                  atol=1e-5)), "probabilities do not sum to 1")
        check(bool(torch.allclose(probs.cpu(), ref_probs, atol=1e-6)),
              "probabilities differ from the CPU plain path")
        rel = ((got - ref_logits).abs().max()
               / ref_logits.abs().max()).item()
        worst_rel = max(worst_rel, rel)
        exact &= torch.equal(got, ref_logits)
        agree.append((got.argmax(1) == ref_logits.argmax(1)).float().mean()
                     .item())
    check(min(agree) == 1.0 and worst_rel <= 1e-4,
          f"ResNet-18 GPU vs CPU: argmax agreement {agree}, max rel error "
          f"{worst_rel}")
    log(f"[5 resnet18 main path] batches 1,3,16 x (probs, logits): launches "
        f"{main_launches} = {n_stages} stages each run and warm-up; vs CPU "
        "plain path "
        f"argmax agreement {min(agree)}, max rel logit error {worst_rel:.2e}, "
        f"bit-exact {exact}")

    # -- 6. the sliced branch end to end: AlexNet, 8-bit ADC -------------
    cfg8 = api.HurryConfig(adc_bits=8)
    alex_gpu = api.compile("alexnet", cfg8, seed=0, device="cuda")
    alex_cpu = api.compile("alexnet", cfg8, seed=0, device="cpu")
    sliced_stages = sum(clip_possible(min(g.tile_rows, st.w8.shape[0]), 8)
                        for (g, _), st in zip(alex_gpu.program.stages(),
                                              alex_gpu.packed.stages))
    x4 = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    got, alex_launches = counted(lambda: alex_gpu.run(x4, logits=True))
    sliced_launches = alex_launches["crossbar_gemm"]
    n_alex = len(alex_gpu.program.stages())
    check(alex_launches == each(2 * n_alex),    # the key's warm-up, replay
          f"AlexNet launches {alex_launches}, expected {2 * n_alex} each")
    ref = alex_cpu.run(x4, logits=True)
    got = got.cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    a_agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
    check(bool(torch.isfinite(got).all()) and a_agree == 1.0 and rel <= 1e-4,
          f"AlexNet adc8 GPU vs CPU: agreement {a_agree}, rel {rel}")
    log(f"[6 alexnet adc_bits=8] {sliced_stages} of {n_alex} stages on the "
        f"sliced branch; vs CPU plain path argmax agreement {a_agree}, max "
        f"rel logit error {rel:.2e}, bit-exact {torch.equal(got, ref)}")

    # -- 7. times ---------------------------------------------------------
    # bounds sum per-shape max(bytes, operations); `by` keeps each
    # shape's binding term so the sum can say which one dominates.  The
    # GEMM runs in the main path's form: x laid out by kernel_layout (as
    # the executor quantizes into it) and the stage's mounted wt.
    g = {}
    for b in (16, 1):
        gb = dict(ms=0.0, plain=0.0, row=0.0, kmaj=0.0, stages=[],
                  by={"bytes": 0.0, "operations": 0.0})
        for s in shapes if b == 16 else stage_shapes(resnet_gpu, 1):
            M, K, N, rows = s["M"], s["K"], s["N"], s["rows"]
            x, w, wt = rand_i8(M, K), s["w8"], s["wt"]
            xk = kernel_layout(x, K, rows=rows).contiguous()
            g_ms = device_ms(lambda: crossbar_gemm(xk, w, rows=rows, wt=wt))
            g_plain = device_ms(lambda: crossbar_gemm_exact_ref(x, w))
            lib_row, lib_k = int_mm_ms(x, w)
            b_ms, o_ms = gemm_bound(M, N, K, sliced=False)
            gb["by"]["bytes" if b_ms >= o_ms else "operations"] += max(b_ms,
                                                                      o_ms)
            gb["ms"] += g_ms
            gb["plain"] += g_plain
            gb["row"] += lib_row
            gb["kmaj"] += lib_k
            gb["stages"].append((g_ms - max(b_ms, o_ms), s["name"], g_ms,
                                 max(b_ms, o_ms)))
            line = (f"time b{b} {s['name']}: M={M} K={K} N={N} gemm "
                    f"{g_ms:.4f} ms (bound {max(b_ms, o_ms):.5f}, plain "
                    f"{g_plain:.4f}, _int_mm row-major {lib_row:.4f}, "
                    f"K-major {lib_k:.4f})")
            detail(line)
        for gap, name, ms, bnd in sorted(gb["stages"], reverse=True)[:5]:
            detail(f"top offender b{b} {name}: {ms:.4f} ms, bound {bnd:.5f}"
                   f", gap {gap:.4f} ms")
        g[b] = gb
    f = fb_stage_times(shapes, dev, gen)
    # the AlexNet adc_bits=8 path's GEMMs (batch 4): all but conv1 sliced
    sl = dict(ms=0.0, plain=0.0, by={"bytes": 0.0, "operations": 0.0})
    for s in stage_shapes(alex_gpu, 4):
        M, K, N, rows = s["M"], s["K"], s["N"], s["rows"]
        x, w, wt = rand_i8(M, K), s["w8"], s["wt"]
        xk = kernel_layout(x, K, rows=rows, adc_bits=8).contiguous()
        is_sliced = clip_possible(min(rows, K), 8)
        s_ms = device_ms(lambda: crossbar_gemm(xk, w, adc_bits=8, rows=rows,
                                               wt=wt))
        s_plain = device_ms(
            lambda: crossbar_gemm_ref(x, w, adc_bits=8, rows=rows)
            if is_sliced else crossbar_gemm_exact_ref(x, w), calls=5)
        b_ms, o_ms = gemm_bound(M, N, K, sliced=is_sliced)
        sl["by"]["bytes" if b_ms >= o_ms else "operations"] += max(b_ms, o_ms)
        sl["ms"] += s_ms
        sl["plain"] += s_plain
        detail(
            f"time alexnet-adc8 {s['name']}: M={M} K={K} N={N} "
            f"{'sliced' if is_sliced else 'exact'} {s_ms:.4f} ms (bound "
            f"{max(b_ms, o_ms):.5f}, plain {s_plain:.4f})")
    e2e = {}
    for b in (1, 16):
        xb = torch.randn(b, 32, 32, 3, generator=gen, device=dev)
        e2e[b] = wall_ms(lambda: resnet_gpu.run(xb))

    busy, idle = {}, {}
    for b in (1, 16):
        xb = torch.randn(b, 32, 32, 3, generator=gen, device=dev)
        busy[b], top = forward_profile(lambda: resnet_gpu.run(xb))
        idle[b] = "not measured" if busy[b] is None else \
            f"{1 - busy[b] / e2e[b]:.1%}"
        detail(f"resnet18 b{b} forward: device busy "
               f"{'not measured' if busy[b] is None else f'{busy[b]:.3f} ms'}"
               f" of {e2e[b]:.3f} ms, idle {idle[b]}")
        for ms, n, name in top:
            detail(f"  {name}: {ms:.4f} ms in {n} launches")

    def bound(by: dict) -> tuple[float, str]:
        return sum(by.values()), max(by, key=by.get)

    wd = wide_times(gen)
    detail(f"time {wd['stage']} b1024: M={wd['M']} K={wd['K']} N={wd['N']} "
           f"wide tiles {wd['ms']:.4f} ms (bound {wd['bound']:.4f} by "
           f"{wd['by']}, plain {wd['plain']:.4f}, _int_mm K-major "
           f"{wd['lib']:.4f})")
    g_bound, g_by = bound(g[16]["by"])
    g1_bound, g1_by = bound(g[1]["by"])
    s_bound, s_by = bound(sl["by"])
    # the library yardstick: _int_mm on the faster of the two layouts
    lib_layout = "row-major" if g[16]["row"] <= g[16]["kmaj"] else "K-major"
    g_lib = min(g[16]["row"], g[16]["kmaj"])
    log(f"[7 times] per ResNet-18 batch-16 forward: crossbar_gemm "
        f"{g[16]['ms']:.3f} ms (bound {g_bound:.4f} by {g_by}, plain "
        f"{g[16]['plain']:.3f}, torch._int_mm row-major {g[16]['row']:.3f} / "
        f"K-major {g[16]['kmaj']:.3f}, library_ms {lib_layout}); per "
        f"batch-1 forward: crossbar_gemm "
        f"{g[1]['ms']:.3f} ms (bound {g1_bound:.4f} by {g1_by}, plain "
        f"{g[1]['plain']:.3f}, torch._int_mm row-major {g[1]['row']:.3f} / "
        f"K-major {g[1]['kmaj']:.3f}); fb_epilogue b16 "
        f"{f['ms']:.3f} ms (bound {f['bound']:.4f} by bytes, plain "
        f"{f['plain']:.3f}); AlexNet adc8 b4 crossbar_gemm {sl['ms']:.3f} ms "
        f"(bound {s_bound:.4f} by {s_by}, plain {sl['plain']:.3f}); "
        f"{wd['stage']} b1024 wide tiles {wd['ms']:.3f} ms (bound "
        f"{wd['bound']:.4f} by {wd['by']}, _int_mm K-major {wd['lib']:.3f}); "
        f"resnet18 end to end {e2e[1]:.3f} ms at b=1, {e2e[16]:.3f} ms at "
        f"b=16; device idle {idle[1]} at b=1, {idle[16]} at b=16")

    # -- 8. batched launches at vit_tiny's dynamic shapes ----------------
    b_exact_err, b_sliced_err, b_fb_err = batched_phase(dev, gen)
    gemm_err = max(gemm_err, b_exact_err)
    sliced_err = max(sliced_err, b_sliced_err)
    fb_err = max(fb_err, b_fb_err)
    torch.cuda.synchronize()
    log("[8 batched launches] 48 slices of 64x64x64, one launch each: "
        "crossbar_gemm exact and sliced equal to the plain version and to "
        "the per-slice 2-D calls (torch.equal), 5 ragged slices of "
        "16x1001x19 equal at rows 511/247/494; fb_epilogue dequant equal, "
        "softmax+post_scale max |kernel - plain| "
        f"{b_fb_err:.2e} (limit 1e-6)")

    # -- 9-11. the new kernels against their plain versions --------------
    flash_err, flash_report = flash_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[9 flash_attention] {flash_report}; max |kernel - plain| float32 "
        f"{flash_err:.2e}")
    fused_err, fused_report = fused_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[10 fused_gemm_epilogue] {fused_report}; max |kernel - plain| "
        f"float32 {fused_err:.2e}")
    packed_err, packed_report = packed_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[11 packed_gemm] {packed_report}; max err float32 "
        f"{packed_err:.2e}")

    # -- 12. the sequence path: vit_tiny serving requests ----------------
    vit_gpu = api.compile("vit_tiny", api.HurryConfig(), seed=0,
                          device="cuda")
    vit_cpu = api.compile("vit_tiny", api.HurryConfig(), seed=0,
                          device="cpu")
    vit = vit_phase(vit_gpu, vit_cpu, rng)
    vit_e2e, vit_idle = {}, {}
    for b in (1, 16):
        xb = torch.randn(b, 32, 32, 3, generator=gen, device=dev)
        vit_e2e[b] = wall_ms(lambda: vit_gpu.run(xb))
        busy, top = forward_profile(lambda: vit_gpu.run(xb))
        vit_idle[b] = "not measured" if busy is None else \
            f"{1 - busy / vit_e2e[b]:.1%}"
        detail(f"vit_tiny b{b} forward: device busy "
               f"{'not measured' if busy is None else f'{busy:.3f} ms'}"
               f" of {vit_e2e[b]:.3f} ms, idle {vit_idle[b]}")
        for ms, n, name in top:
            detail(f"  {name}: {ms:.4f} ms in {n} launches")
    log(f"[12 vit_tiny main path] batches 1,3,16 x (probs, logits): launches "
        f"{vit['launches']} = {vit['n_stages']} stages each run and "
        "warm-up, "
        f"{vit['n_dyn']} dynamic stages per run with two quantize_layout, "
        f"one crossbar_gemm and one fb_epilogue each ({vit['dyn_runs']} "
        "dynamic-stage calls); vs "
        f"CPU plain path argmax agreement {vit['agree']}, max rel logit "
        f"error {vit['rel']:.2e} (limit {VIT_REL}), max |probs diff| "
        f"{vit['prob']:.2e} (limit {VIT_PROB_ATOL}); end to end {vit_e2e[1]:.3f} ms at b=1, "
        f"{vit_e2e[16]:.3f} ms at b=16; device idle {vit_idle[1]} at b=1, "
        f"{vit_idle[16]} at b=16")
    vd = vit_draws_phase(vit_gpu, vit_cpu)
    flipped = [(name, n) for name, n, _ in vd["flips"] if n]
    log("[12 vit_tiny draws] batch 16, GPU against the CPU plain path: "
        + "; ".join(f"seed {d['seed']} max rel logit gap {d['rel']:.2e}, "
                    f"argmax agreement {d['agree']:.4f}"
                    for d in vd["draws"])
        + f" (printed, not held). Teacher-forced on seed {vd['worst']}: "
        f"{len(vd['forced'])} stages from the CPU path's buffers, int32 GEMM "
        "outputs torch.equal in all, FB outputs within FB_CASES' tolerances "
        f"(max err {max(f['fb_err'] for f in vd['forced']):.2e}); free run: "
        + (f"int8 operands first differ at stage {flipped[0][0]}, per stage "
           + ", ".join(f"{name} {n}" for name, n in flipped)
           if flipped else "no int8 operand differs"))

    # -- 13. the attention path ------------------------------------------
    from repro_torch.kernels import ops
    attn_model = api.compile(attention_graph(api),
                             api.HurryConfig(array_rows=511), seed=0,
                             buckets=(), device="cuda")
    torch.cuda.synchronize()
    attn_launches, attn_cases = attention_phase(attn_model, dev, gen)
    torch.cuda.synchronize()
    parts = []
    for T, x, q, k, v, rel, corr in attn_cases:
        t_cb = wall_ms(lambda: attn_model.run(x))
        t_fl = wall_ms(lambda: ops.attention(q, k, v, causal=False))
        parts.append(f"T={T}: rel {rel:.3f} corr {corr:.4f}, crossbar "
                     f"{t_cb:.3f} ms, flash {t_fl:.3f} ms")
    log(f"[13 attention path] flash_attention launches {attn_launches}; "
        + "; ".join(parts) + " (host clock + synchronize, median of 10)")

    # -- 14. the ops entry point -----------------------------------------
    ops_launches = ops_phase(dev, gen)
    log(f"[14 kernels.ops] launches {ops_launches}; each within tolerance "
        "of its plain version")

    # -- 15. times of the new kernels ------------------------------------
    # vit_tiny's dynamic stages at batch 16: 48 (batch, head) slices
    S = 16 * 3
    xs, ws = rand_i8(S, 64, 64), rand_i8(S, 64, 64)
    dg_ms = device_ms(lambda: crossbar_gemm(xs, ws, rows=64))
    dg_plain = device_ms(lambda: crossbar_gemm_exact_ref(xs, ws))
    dfb = dyn_fb_times(dev, gen, S)
    df_ms, df_plain, df_bound = dfb["ms"], dfb["plain"], dfb["bound"]
    b_ms, o_ms = (S * t for t in gemm_bound(64, 64, 64, sliced=False))
    dg_bound = max(b_ms, o_ms)
    pairs = vit["n_dyn"] // 2       # (scores, context) stage pairs
    detail(f"time vit_tiny dynamic stages (b16, {S} slices of 64x64x64, "
           f"{vit['n_dyn']} per forward): crossbar_gemm {dg_ms:.4f} ms per "
           f"launch (bound {dg_bound:.5f} by "
           f"{'bytes' if b_ms >= o_ms else 'operations'}, plain "
           f"{dg_plain:.4f}); fb_epilogue scores+context {df_ms:.4f} ms "
           f"(bound {df_bound:.5f} by bytes, plain {df_plain:.4f})")
    # flash_attention over the attention path's shapes (1, T, 4, 16), and
    # at the timed shapes beside SDPA
    flt = flash_times(dev, gen)
    fl = flt["path"]
    flash_vs = "; ".join(
        f"{tuple(t['shape'])}{' causal' if t['causal'] else ''} {t['dtype']} "
        f"{t['ms']:.4f} ms (sdpa {t['sdpa_ms']:.4f}, bound "
        f"{t['bound_ms']:.5f})" for t in flt["shapes"])
    # the float GEMMs at the kernel bench's shapes and a larger one each,
    # float32 and bfloat16; the JSON rows are the bench's float32 calls
    # (fused: SiLU beside addmm, which leaves the activation out; packed:
    # beside the per-group matmul loop)
    fg = float_gemm_times(dev, gen)
    fu, pk = fg["fused"][0], fg["packed"][0]

    def lib_text(lib: dict) -> str:
        return ", ".join(f"{k} {'refused' if v is None else f'{v:.4f}'}"
                         for k, v in lib.items())

    gemm_vs = "; ".join(
        [f"fused_gemm_epilogue {'x'.join(map(str, r['shape']))} {r['act']} "
         f"{r['dtype']} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} by "
         f"{r['bound_by']}, plain {r['plain_ms']:.4f}, "
         f"{lib_text(r['library_ms'])})" for r in fg["fused"]]
        + [f"packed_gemm {r['groups']} groups {r['rows']}x{r['K']}x{r['N']} "
           f"{r['dtype']} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} by "
           f"{r['bound_by']}, plain {r['plain_ms']:.4f}, "
           f"{lib_text(r['library_ms'])})" for r in fg["packed"]])
    fl_bound, fl_by = bound(fl["by"])
    log(f"[15 times] vit_tiny b16 dynamic stages per forward: crossbar_gemm "
        f"{pairs * 2 * dg_ms:.4f} ms in {2 * pairs} batched launches (bound "
        f"{pairs * 2 * dg_bound:.5f}, plain {pairs * 2 * dg_plain:.4f}); "
        f"fb_epilogue {pairs * df_ms:.4f} ms (bound {pairs * df_bound:.5f}, "
        f"plain {pairs * df_plain:.4f}); flash_attention over T=16,64,256 "
        f"(1,T,4,16) {fl['ms']:.4f} ms (bound {fl_bound:.5f} by {fl_by}, "
        f"plain {fl['plain']:.4f}, sdpa {fl['lib']:.4f}); {flash_vs}; "
        f"{gemm_vs}")

    # -- 16-20. the rest of repro_torch.api ------------------------------
    rng2 = np.random.default_rng(16)
    vgg = vgg_phase(api, rng2)
    log(f"[16 vgg16 main path] batches 1,16 x (probs, logits): launches "
        f"{vgg['launches']} = {vgg['n_stages']} stages each run and "
        "warm-up; logits "
        "torch.equal to the CPU plain path at both batches, probabilities "
        f"within 1e-6; end to end {vgg['ms'][1]:.3f} ms at b=1, "
        f"{vgg['ms'][16]:.3f} ms at b=16 (host clock + synchronize, median "
        f"of 10) | {card}")
    sl_ = save_load_phase(api, {"resnet18": resnet_gpu,
                                "vit_tiny": vit_gpu}, gen)
    log("[17 save/load] " + "; ".join(
        f"{name}: compile {m['compile_s']:.3f} s, load {m['load_s']:.3f} s, "
        f"file {m['mb']:.2f} MiB" for name, m in sl_["models"].items())
        + f"; loaded b16 runs torch.equal to the in-memory models, launches "
        f"{sl_['launches']} | {card}")
    srv = server_phase(api, resnet_gpu, rng2)
    log(f"[18 ProgramServer] resnet18 batches 1,3,16 torch.equal to "
        f"CompiledModel.run, launches {srv['launches']}; b16 "
        f"{srv['ms']:.3f} ms per batch beside run's {srv['run_ms']:.3f} ms "
        f"| {card}")
    fn = functional_phase(api, {
        "resnet18": (resnet_gpu, resnet_cpu, 1e-4, 1e-6, True),
        "vit_tiny": (vit_gpu, vit_cpu, VIT_REL, VIT_PROB_ATOL, False)}, rng2)
    log(f"[19 functional model] crossbar_matmul {fn['branches']} calls "
        "torch.equal to the CPU, one crossbar_gemm launch each; read noise "
        "card/CPU " + ", ".join(f"sigma {s}: {g:.4e}/{c:.4e}"
                                for s, (g, c) in fn["noise"].items())
        + f" (within {NOISE_REL:.0%}); graph.forward(mm=crossbar) b16: "
        + "; ".join(
            f"{name} {f['launches']} crossbar_gemm launches per forward, vs "
            f"CPU rel {f['rel']:.2e} probs {f['prob']:.2e} bit-exact "
            f"{f['exact']} argmax agreement {f['agree']:.4f} (flipped rows' "
            f"CPU top-two margin / max|logit|: {f['margins'] or 'none'}), "
            f"vs run on the card rel {f['run_gap']:.2e}, "
            f"{f['ms']:.3f} ms per batch beside run's {f['run_ms']:.3f} ms"
            for name, f in fn["forward"].items()) + f" | {card}")
    sims = {arch: resnet_gpu.simulate(arch).summary()
            for arch in api.SIM_ARCHS}
    check(all(all(math.isfinite(v) and v > 0 for v in r.values())
              for r in sims.values()), f"simulate: {sims}")
    log("[20 simulate] resnet18 on the host: " + "; ".join(
        f"{arch} " + ", ".join(f"{k} {v:.6g}" for k, v in r.items())
        for arch, r in sims.items()))

    # -- 27. the executable per bucket (before the LM phases: the profiler
    # reads every kernel of a replay in a process that has not traced
    # them) ------------------------------------------------------------------
    xp = executable_phase(api, dev)
    log(executable_line(xp, card))
    # -- 29. quantize_layout on the executor's path -------------------------
    qp = quantize_phase(api, dev)
    log(quantize_line(qp, card))
    # -- 28. the compiled decode step's cases -------------------------------
    log(decode_cases_line(decode_cases_phase(dev), card))
    # -- 21. the LM serving stack ------------------------------------------
    log(lm_line(lm_phase(dev), card))
    # -- 22. the LM training path ------------------------------------------
    log(train_line(train_phase(dev), card))
    # -- 23 (b). the mesh dry-run's three processes (host cores only) run
    # in the background beside 24-26; 23's line follows 26
    with ThreadPoolExecutor(1) as background:
        dry = background.submit(timed_dryrun)
        # -- 24. the examples and the entry points --------------------------
        ex = examples_phase(dev)
        for ln in ex["quick"]["sim"].splitlines():
            if ln:
                log(f"[24 quickstart resnet18 simulate] {ln}")
        log(examples_line(ex, card))
        # -- 25. crossbar programs at other widths --------------------------
        # (26 (a) runs on the card while 25's CPU references finish)
        wp = widths_phase(dev, gen, meanwhile=lambda: lm_wide_a(dev))
        log(widths_line(wp, card))
        # -- 26. every LM family at full width ------------------------------
        log(lm_wide_line(lm_wide_phase(dev, wp["meanwhile"]), card))
        # -- 23. the LM sharding and the mesh dry-run -----------------------
        log(shard_line(shard_phase(dev, dryrun=dry), card))
    paths = [main_launches, vit["launches"], vgg["launches"],
             sl_["launches"], srv["launches"], ex["quick"]["launches"],
             ex["v1"]["launches"], ex["program"]["launches"], wp["launches"],
             xp["launches"]]
    path_launches = {k: sum(p[k] for p in paths) for k in PROGRAM_KERNELS}
    path_launches["crossbar_gemm"] += sum(
        f["total"] for f in fn["forward"].values()) + ex["xbar"]["launches"]

    kernels = [
        dict(name="crossbar_gemm", route="cuda",
             source="src/repro_torch/kernels/csrc/crossbar_gemm.cu",
             replaces="src/repro/kernels/crossbar_gemm.py:116",
             launches=path_launches["crossbar_gemm"], max_abs_err=gemm_err,
             ms=g[16]["ms"], plain_ms=g[16]["plain"], bound_ms=g_bound,
             bound_by=g_by, library_ms=g_lib),
        dict(name="crossbar_gemm (wide tiles)", route="cuda",
             source="src/repro_torch/kernels/csrc/crossbar_gemm.cu",
             replaces="src/repro/kernels/crossbar_gemm.py:116",
             launches=wide["launches"], max_abs_err=wide["err"],
             ms=wd["ms"], plain_ms=wd["plain"], bound_ms=wd["bound"],
             bound_by=wd["by"], library_ms=wd["lib"]),
        dict(name="crossbar_gemm (sliced path)", route="cuda",
             source="src/repro_torch/kernels/csrc/crossbar_gemm.cu",
             replaces="src/repro/kernels/crossbar_gemm.py:77",
             launches=sliced_launches + wp["sliced"],
             max_abs_err=max(sliced_err, wp["narrow"]["err"]),
             ms=sl["ms"], plain_ms=sl["plain"], bound_ms=s_bound,
             bound_by=s_by, library_ms=None),
        dict(name="fb_epilogue", route="cuda",
             source="src/repro_torch/kernels/csrc/fb_epilogue.cu",
             replaces="src/repro/kernels/fb_epilogue.py:102",
             launches=path_launches["fb_epilogue"], max_abs_err=fb_err,
             ms=f["ms"], plain_ms=f["plain"], bound_ms=f["bound"],
             bound_by="bytes", library_ms=None),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:28",
             launches=attn_launches["flash_attention"], max_abs_err=flash_err,
             ms=fl["ms"], plain_ms=fl["plain"], bound_ms=fl_bound,
             bound_by=fl_by, library_ms=fl["lib"]),
        dict(name="fused_gemm_epilogue", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_gemm_epilogue.cu",
             replaces="src/repro/kernels/fused_gemm_epilogue.py:23",
             launches=ops_launches["fused_gemm_epilogue"],
             max_abs_err=fused_err, ms=fu["ms"], plain_ms=fu["plain_ms"],
             bound_ms=fu["bound_ms"], bound_by=fu["bound_by"],
             library_ms=fu["library_ms"]["addmm"]),
        dict(name="packed_gemm", route="cuda",
             source="src/repro_torch/kernels/csrc/packed_gemm.cu",
             replaces="src/repro/kernels/packed_gemm.py:26",
             launches=ops_launches["packed_gemm"], max_abs_err=packed_err,
             ms=pk["ms"], plain_ms=pk["plain_ms"], bound_ms=pk["bound_ms"],
             bound_by=pk["bound_by"],
             library_ms=pk["library_ms"]["matmul loop"]),
        dict(name="quantize_layout", route="cuda",
             source="src/repro_torch/kernels/csrc/quantize_layout.cu",
             replaces="src/repro/program/execute.py:148-164 and :113-127 "
             "(XLA's fusions under jax.jit and jax.vmap; no Pallas kernel)",
             launches=path_launches["quantize_layout"],
             max_abs_err=qp["err"], ms=qp["times"][16]["ms"],
             plain_ms=qp["times"][16]["plain"],
             bound_ms=qp["times"][16]["bound"], bound_by="bytes",
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
