#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases, one JSON line each:

  env           torch/CUDA versions and the card's name and power limit
  build         compiles every CUDA source of the port from ``src/repro_torch/csrc``
                (the two fedcore sources, ssd_scan.cu, flash_attention.cu,
                flash_decode.cu and rmsnorm.cu, with the shared csrc/hopper.cuh),
                one nvcc each, all at once; counts the HGMMA (wgmma)
                instructions in flash_attention's and ssd_scan's SASS
  server_apply  the fused server-step kernel against its plain PyTorch version at
                photon-75m's flat size (Np = 74,104,832, C = 4) for FedAvg,
                FedMom and FedAdam, with and without DP noise, and FedAvg at
                C = 2 (the async flush's buffer) and C = 40 (two chunks of
                clients): max errors, run-to-run bitwise norms, kernel /
                plain / bound times; then FedAvg at C = 2 on poisoned
                buffers (a NaN lane, a +inf lane and a x64 lane at weight
                > 0, a NaN lane at weight 0): NaN and ±inf at the plain
                version's positions, finite values to the tolerance
  topk_mask_ef, sr_bf16, int8_quant, int8_dequant
                each uplink codec kernel at Np = 74,104,832, C = 4 (a sync
                cohort) and C = 1 (one async client), bitwise against its
                plain version: kernel / plain / bound times, GB/s; the top-k
                phase also times the threshold selection; int8_dequant also
                at C = 1 with the scale plane NaN, +inf and x64 (what a
                Byzantine client's corrupted int8 payload carries), bitwise
  ssd_scan      the SSD chunk-scan kernel against its plain version at
                mamba2-1.3b's full per-layer prefill shape (B = 4, S = 2048,
                nh = 64, hd = 64, G = 1, ds = 128, chunk = 64), from a
                nonzero state: bf16 (the tensor-core kernel) and f32 (the
                CUDA-core kernel), kernel / plain / bound times (bf16 against
                the tensor cores' peak, f32 against the CUDA cores'), device
                and host enqueue times; and bf16 at S = 2000 through
                ``ops.ssd``'s padding; then jamba-v0.1-52b's SSM layer
                (B = 2, S = 2048, nh = 128, hd = 64, G = 1, ds = 16, chunk
                = 64, bf16: the CUDA-core kernel) and its S = 2000
  flash_attention
                the flash attention kernel against its plain version at
                whisper-large-v3's encoder layer (B = 4, H = 20, S = 1500,
                hd = 64, bf16, non-causal) and at small cases (causal with
                q_offset, sliding windows, GQA groups of 2 and 4, hd 128,
                f32, ragged lengths, rows that see no key), bf16 and f32:
                max error, kernel / plain / F.scaled_dot_product_attention /
                bound times (bf16 against the tensor cores' peak, f32 against
                the CUDA cores'), the exponentials' time at the SMs' ex2 rate,
                device and host enqueue times; then
                ``ops.flash_attention`` at the encoder layer on model-layout
                (B, S, H, hd) tensors: exactly one device kernel under
                torch.profiler, o contiguous and within the tolerance
  flash_alibi   the causal ALiBi training pair through
                ``ops.flash_attention_alibi`` at photon-1.3b's layer in the
                s2048 and s512 cells (B = 1, S = 2048 and B = 4, S = 512; H =
                16, hd = 128, bf16): one forward and two backward launches a
                call; o and lse within the tolerance of the float32 plain
                forward; dq, dk and dv against the float32 plain backward,
                each within 1.25 times the plain bf16 core's
                (``sdpa_chunked``) error; the same bits twice; forward and
                backward times beside ``sdpa_chunked``'s, SDPA's with the
                ALiBi bias as a float mask, and the bounds (operations)
  flash_decode  the flash decode kernel through its entry point ``ops.flash_decode``
                (model-layout caches read in place; each case's shape read
                from its config and input shape) at qwen3-1.7b's decode_32k
                attention layer (B = 128, Hq = 16, Hkv = 8, S = 32768, hd = 128,
                bf16; 17.18 GB of cache) and gemma3-4b's long_500k global and
                local (window 1024) layers (B = 1, Hq = 8, Hkv = 4, S = 524288,
                hd = 256, bf16), each call with the launch counts zeroed just
                before and read just after; against its plain version (on the
                first 8 rows at B = 128) and at small masked, GQA and ragged
                cases in bf16 and f32: max error, kernel / plain /
                F.scaled_dot_product_attention (and the kernels it ran) / bound
                times over the bytes the seen keys need; device and host
                enqueue times, also of ``ops.flash_decode`` with an int kv_len
  rmsnorm       the RMSNorm kernel through ``ops.rmsnorm`` at qwen3-1.7b's
                prefill_32k activations (1,048,576 x 2048, bf16) and at
                mamba2-1.3b's serve prefill rows (8192 x 2048, bf16), counted
                as above, and at small cases (ragged widths, rows too long for
                registers, f32): max error, kernel / plain / F.rms_norm / bound
  check         a reduced photon round on the card agrees with the same round on
                the CPU (float32 compute), with the float32 and the top-k uplink,
                and so do two reduced async updates (heavy stragglers);
                reduced mamba2-1.3b, photon-75m, whisper-large-v3, gemma3-4b,
                deepseek-moe-16b and jamba-v0.1-52b ``generate`` (float32,
                use_pallas) give the same tokens on the card and on the CPU
  train         ``repro_torch.launch.train --arch photon-75m --fused-server``
                for two rounds at full width on the card, with ``--uplink``
                float32, topk, bf16 and int8; the kernel launch counts are
                zeroed just before each and read just after
  train_async   the same launcher with ``--aggregation async --rounds 3
                --straggler-profile heavy --dropout-rate 0.1`` (K = 4, a buffer
                of M = 2), once per ``--uplink``, counted as above and held
                exactly to the driver's own counts: ``server_apply`` once per
                non-empty flush (= 3), the encode kernel once per client phase,
                ``int8_dequant`` once per admission, no other kernel. Per
                update: seconds, admitted deltas, tokens/s, staleness, val_ppl,
                the simulated speedup; per run: peak device memory, the
                device's busy share of one more update under torch.profiler,
                and the wall time of the parts of one more (client phases,
                admissions, flush, the rest) and of one validation
  train_tiled   the launcher without --fused-server at full width, --clients 16
                --population 32 --local-steps 4 --rounds 2: flat, --cohort-tile 4
                and --cohort-tile 4 --robust-agg trimmed; round seconds, peak
                device memory, val_ppl, no kernel launched; a one-tile round
                (K = 4, --cohort-tile 4) bitwise the flat round (loss and
                params); the tiled fold's sort (tile_fold_update) timed at
                photon-75m's leaves for the trimmed and median depths
  train_byzantine
                --aggregation async --fused-server --straggler-profile heavy
                --dropout-rate 0.1 --clients 4 --population 8 --local-steps 2
                --seq-len 64 --rounds 6 --byzantine-fraction 0.25
                --byzantine-kind nan --rollback --rollback-window 2 at full
                width, with --uplink float32 and int8: per update rolled_back,
                pseudo_grad_norm and val_ppl; the rollback at update 3 only;
                launch counts held to AsyncFederationDriver's counters; finite params
  centralized   8 centralized_step calls at photon-75m full width on a global
                batch of 16 x 128 tokens: tokens/s and peak device memory
  train_governed
                --aggregation async --fused-server --straggler-profile heavy
                --control staleness --control-target 0.5 --rounds 5, float32
                and int8: per update the buffer size M, alpha and the width C
                of its server_apply launch (M = 2, 1, 2, 4, 4, as on the
                CPU); launches held to the driver's counters; server_apply
                held to its plain version at every width the run gave it
  train_cohort  sync --fused-server --straggler-profile heavy --deadline 4
                --dropout-rate 0.2 --control cohort --control-target 0.95
                --local-steps 4 --rounds 4: K per round and server_apply's C
                (4, 6, 8, 8), each width held as above; then --control
                static bitwise the run without the flag (rows and params)
  train_sockets the async path over --runtime sockets at full width, float32
                and int8: the CLI's server on the main thread and two worker
                threads, bitwise the in-process run (rows but the wall clock,
                and params); per update the wall seconds, the wire bytes each
                way, the server's framing seconds (CRC and copies) and device
                memory; int8_quant once per executed assignment, int8_dequant
                once per admission, server_apply once per flush; then one
                real run of three processes (``chip_smoke.py --cli-process``:
                a server and two workers through the CLI, each with a
                timeout, each reporting its peak device memory and framing
                seconds), whose last row equals the in-process CLI's
  serve         full-width mamba2-1.3b (48 layers, random weights from seed 0):
                ``Model.prefill(use_pallas=True)`` at B = 4, S = 2048 against
                ``use_pallas=False`` on the card (float32 compute: held to a
                tolerance; bf16: reported), then ``generate(use_pallas=True)``
                with 16 new tokens, exactly 48 ssd_scan launches per prefill and
                none per decode step, the bf16 prefill's profile showing the
                tensor-core kernel 48 times; then full-width photon-75m ``generate`` at
                B = 4, prompt 512, 16 new tokens, with no kernel launched.
                Prefill seconds, decode tokens/s, peak device memory, and a
                torch.profiler breakdown of one prefill and one decode step
                (device time by kernel, the device's busy share)
  serve_whisper full-width whisper-large-v3 (32 encoder and 32 decoder layers,
                random weights from seed 0): B = 4, 1500 audio frames of randn
                embeddings, a 432-token prompt, 16 new tokens (448 decoder
                positions, Whisper's text context). Float32
                ``prefill(use_pallas=True)`` against ``use_pallas=False`` on the
                card (held to 1e-4), the bf16 greedy tokens of both compared,
                then ``generate(use_pallas=True)``: exactly 32 flash_attention
                launches per prefill, none per decode step, no other kernel;
                the serve numbers and profile as above
  serve_families
                every dense RoPE/GQA decoder and MoE arch at its published
                widths (random f32 weights from ``Model.init(0,
                device="cuda")``, bf16 compute): granite-3-2b, qwen3-1.7b and
                gemma3-4b whole; deepseek-coder-33b (20 of 62 layers),
                chameleon-34b (14 of 48), deepseek-moe-16b (20 of 28),
                llama4-scout-17b-a16e (4 of 48) and jamba-v0.1-52b (6 of 32,
                MMMMAM), each at most 48 GB of f32 weights. B = 2, a
                2048-token prompt, 16 greedy tokens through ``generate(
                use_pallas=True)``: prefill ms, decode ms a step, peak memory,
                the profiles; no kernel launch on any arch but jamba, which
                launches ssd_scan 5 times per prefill and never in a decode
                step; jamba's prefill also with use_pallas against without,
                float32 (its first SSM layer's caches held to 1e-4) and bf16
  train_moe     ``launch/train.run`` on deepseek-moe-16b at published widths
                cut to 2 layers (1,093,281,792 params; layer 0 dense, layer 1
                MoE): --fused-server --clients 2 --population 4 --rounds 2:
                server_apply once per round at C = 2 over N past 2^31 / C,
                no other kernel; finite loss, val_ppl and moe_aux; peak
                memory and round seconds; server_apply held to its plain
                version at that (C, N)
  examples      the port's five examples (``repro_torch.examples``) through their
                ``main`` on the card, the kernel counts zeroed just before each
                run and read just after: quickstart and serve_batched as the
                reference runs them (no kernel but, in quickstart, the ALiBi
                training pair); every run that trains photon in bf16 launches
                the pair, held to one forward a layer per training and
                evaluation batch and two backward kernels a layer per
                training batch, and left out of the counts below;
                heterogeneous_federation
                --fused-server --uplink topk --rounds 2 (server_apply and
                topk_mask_ef once per round, nothing else) and --aggregation
                async --uplink int8 --rounds 2 --fused-server (launches held to
                the driver's n_client_phases / n_admissions / n_flushes); each
                codec launch of those two runs then held bitwise to its plain
                version on the inputs it was given (one case per shape), and
                server_apply at each (C, Np) they gave it;
                pretrain_e2e --full --fused-server in a fresh temporary
                directory (photon-125m at published widths, 4 rounds x 100
                local steps of 4 clients, B = 4, S = 512: server_apply once per
                round at C = 4, a finite loss; round seconds, tokens/s, peak
                memory; server_apply then held to its plain version at C = 4
                over photon-125m's flat N); then socket_federation --demo round,
                kill-resume, chaos and corrupt with --fused-server, four
                processes started together (each with its own server and
                workers), each to exit 0 with its PASS lines, round and
                kill-resume bitwise
  mesh          the mesh tooling: ``python -m repro_torch.launch.dryrun --arch
                assigned --shape all --multi-pod both --train-mode both`` (every
                production plan: exit 0, one report per plan, the measured
                terms null); reduced mamba2-1.3b's host-mesh step (int8,
                --fused-server, float32 compute) on the card against the CPU
                (params to 1e-4 at round 0; from round 100 with a seeded
                FedMom lane, the update of the params and of the lane to 1e-3
                of the CPU update's norm); then mamba2-1.3b's federated
                train_4k step from ``launch/steps.build_train_step`` on the
                one-card host mesh at published widths and 48 layers (global
                batch 2, τ = 1: C = 1, grad_accum 2, micro-batch 1 x 4096,
                remat, FedMom, --fused-server), --uplink float32 and int8,
                materialized from seed 0 at round 100 (past the warmup, whose
                lr is 0 at round 0) and run once counted and once timed:
                round seconds, tokens/s, peak memory and
                ``verify_micro_batch``, counted FLOPs and bytes, model FLOPs,
                the roofline terms; exactly one server_apply per run (and one
                int8_quant and one int8_dequant under int8); under int8 a
                third run records the codecs' inputs under torch.profiler
                (the device's busy share, the device time of
                select_backward, add and the other large ops); each launch
                held to its plain version at its recorded shape (codecs
                bitwise, server_apply under FedMom);
                the host-mesh CLI at mamba2-1.3b's decode_32k and long_500k
                (exit 0, measured peaks, no kernel); the micro-batch estimate
  timing        the wall seconds of each phase and their sum (the script
                must end within 1,200 s)
  kernels       one line {"kernels": [...]} with every kernel's numbers; the
                fedcore kernels' entries add the async path's launches
                (``async_launches``), the Byzantine run's
                (``byzantine_launches``) and the kernel's numbers at the async
                path's shape (``async_case``: C = 2 or C = 1);
                ``server_apply`` and ``int8_dequant`` list their poisoned
                cases (``poisoned_cases``); the fedcore entries add the
                governed, cohort and socket runs' launches, and
                ``server_apply`` the widths the controller picked with each
                width's kernel / plain / bound times (``width_cases``);
                ``server_apply`` adds train_moe's launches and (C, N) case
                (``moe_launches``, ``moe_case``), ``ssd_scan`` jamba's
                launches and layer case (``jamba_launches``, ``jamba_case``);
                ``server_apply``, ``topk_mask_ef``, ``int8_quant`` and
                ``int8_dequant`` add the examples' launches
                (``examples_launches``), ``server_apply`` its photon-125m case
                (``examples_case``) and heterogeneous_federation's widths
                (``examples_hetero_cases``), the three codecs their cases on
                the inputs heterogeneous_federation gave them
                (``examples_cases``, bitwise); ``server_apply``, ``int8_quant``
                and ``int8_dequant`` add the mesh phase's launches per run by
                uplink (``mesh_launches``) and their case at its shape
                (``mesh_case``); ``flash_attention_alibi_fwd`` and ``_bwd``
                give pretrain_e2e's launches, the examples'
                (``examples_launches``), the held errors (``err``) and
                both layer cases (``cases``)

No model path launches flash_decode or rmsnorm (none does in the JAX package
either), and no decoder layer launches flash_attention (its window is a 0-d
tensor, in both packages): the train and serve phases hold their counts at
0, and the launches of the first two in the kernels line are those of the
entry-point calls above.

The last line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device the script exits 2 before printing a result.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
#: mamba2-1.3b's per-layer prefill shape in the ssd_scan phase and the serve phase
SSD_SHAPE = dict(B=4, S=2048, nh=64, hd=64, G=1, ds=128, chunk=64)
SSD_RAGGED_S = 2000  # not a multiple of the chunk: ops.ssd pads it
SERVE_BATCH, SERVE_GEN, PHOTON_PROMPT = 4, 16, 512
MAMBA2_LAYERS = 48
WHISPER_LAYERS = 32  # encoder layers: one flash_attention launch each per prefill
WHISPER_PROMPT = 448 - SERVE_GEN  # prompt + new tokens = Whisper's 448-token text context
BF16_TC_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
EXP_PER_SM_PER_CLOCK = 16  # MUFU ex2 throughput of one Hopper SM
N_SMS = 132
#: whisper-large-v3's encoder self-attention (B, Hq, Hkv, Sq, Sk, hd, causal,
#: window, q_offset), then small cases of every other option the kernel takes
FLASH_ENCODER = (4, 20, 20, 1500, 1500, 64, False, None, 0)
FLASH_SMALL = [
    (2, 8, 8, 512, 512, 64, True, None, 0),  # causal
    (2, 8, 8, 256, 1024, 64, True, None, 768),  # causal, q_offset = Sk - Sq
    (2, 8, 8, 1000, 1000, 64, True, 128, 0),  # sliding window, ragged
    (2, 16, 8, 700, 700, 128, False, None, 0),  # GQA grp 2, hd 128, ragged
    (2, 16, 4, 333, 333, 64, True, 64, 0),  # GQA grp 4, window, ragged
    (1, 4, 2, 64, 40, 64, True, None, -16),  # rows that see no key
]
#: (arch, input shape, layer): qwen3-1.7b's attention at decode_32k, gemma3-4b's
#: global and local layers at long_500k (:func:`decode_cases` reads their shapes)
DECODE_LAYERS = [
    ("qwen3-1.7b", "decode_32k", None),
    ("gemma3-4b", "long_500k", "global"),
    ("gemma3-4b", "long_500k", "local"),
]
#: rows the plain version takes at B = 128 (its f32 copies of all 128 would be 34 GB)
DECODE_PLAIN_ROWS = 8
#: small masked, GQA and ragged cases: (B, Hq, Hkv, S, hd, kv_len per row, window)
DECODE_SMALL = [
    (4, 8, 2, 1000, 64, (1000, 517, 0, 1), None),  # grp 4, ragged rows, an empty row
    (3, 4, 4, 333, 32, (333, 100, 5), 64),  # grp 1, hd 32, window, kv_len < window
    (2, 16, 2, 4097, 128, (4097, 2000), 100),  # grp 8, window
    (2, 6, 2, 700, 256, (10, 700), 5000),  # grp 3, hd 256, window past the cache
]
#: rows of bf16 activations (:func:`rms_cases`): qwen3-1.7b's at prefill_32k
#: (global batch x sequence), mamba2-1.3b's at the serve phase's prefill
RMS_ROWS = [("qwen3-1.7b", "prefill_32k"), ("mamba2-1.3b", "serve prefill")]
#: small cases: ragged widths (no 16-byte access), rows too long for registers
RMS_SMALL = [(105, 1000), (3, 8192), (7, 4096), (64, 2048), (5, 12288)]
NP_PHOTON_75M = 74_104_832  # photon-75m's 74,100,992 params padded to 8192-blocks
COHORT = 4
WIDE_COHORT = 40  # more clients than one server_apply launch holds (32)
#: the async path's shapes (``chip_smoke.py`` train_async): server_apply over
#: the (M, Np) buffer, the codecs over one client's (1, Np) delta
ASYNC_BUFFER = 2
ASYNC_COHORT = 1
TOPK_FRACTION = 0.05  # the launcher's --topk-fraction default
#: the poisoned server_apply buffers at C = 2: (case, lane 1's content, weights)
POISON_SERVER_CASES = (
    ("nan lane, weight > 0", "nan", (1.0, 1.0)),
    ("+inf lane, weight > 0", "inf", (1.0, 1.0)),
    ("x64 lane, weight > 0", "x64", (1.0, 1.0)),
    ("nan lane, weight 0", "nan", (1.0, 0.0)),
)
#: the scale plane of one client's int8 payload, as a Byzantine client sends it
POISON_SCALE_CASES = ("nan", "inf", "x64")
#: train_tiled: the cohort and its tile (τ cut from 8 to 4: memory does not depend on τ)
TILED_ARGS = ["--arch", "photon-75m", "--clients", "16", "--population", "32",
              "--local-steps", "4", "--rounds", "2", "--uplink", "float32"]
COHORT_TILE = 4
#: train_byzantine: the CPU test's flags, letter for letter, without --reduced
BYZANTINE_ARGS = ["--aggregation", "async", "--fused-server", "--straggler-profile", "heavy",
                  "--dropout-rate", "0.1", "--clients", "4", "--population", "8",
                  "--local-steps", "2", "--seq-len", "64", "--rounds", "6",
                  "--byzantine-fraction", "0.25", "--byzantine-kind", "nan", "--rollback",
                  "--rollback-window", "2"]
#: the updates the reference CLI rolls back on the CPU (--reduced) with these flags
BYZANTINE_ROLLED_BACK = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]
CENTRAL_STEPS, CENTRAL_BATCH, CENTRAL_SEQ = 8, 16, 128  # K·B rows of the default round
#: train_governed: the staleness governor at the launcher's defaults (K = 4, M = 2)
GOVERNED_ARGS = ["--arch", "photon-75m", "--aggregation", "async", "--fused-server",
                 "--straggler-profile", "heavy", "--control", "staleness",
                 "--control-target", "0.5", "--staleness-alpha", "0.5", "--rounds", "5"]
#: the buffer sizes M it flushes at: the timeline and the governor are pure in
#: (config, seed), so the CPU run of the reference CLI gives these too
GOVERNED_WIDTHS = [2, 1, 2, 4, 4]
#: train_cohort: the cohort tuner with the deadline at its cap, so it moves K
COHORT_STATIC_ARGS = ["--arch", "photon-75m", "--fused-server", "--straggler-profile", "heavy",
                      "--deadline", "4", "--dropout-rate", "0.2", "--local-steps", "4",
                      "--rounds", "2"]
COHORT_ARGS = COHORT_STATIC_ARGS[:-1] + ["4", "--control", "cohort", "--control-target", "0.95"]
COHORT_WIDTHS = [4, 6, 8, 8]  # K per round (the reference CLI's on the CPU)
#: train_sockets: the async path over the socket runtime (τ = 8, K = 4, M = 2)
SOCKETS_ARGS = ["--arch", "photon-75m", "--aggregation", "async", "--fused-server",
                "--straggler-profile", "heavy", "--rounds", "3"]
#: serve_families: every dense RoPE/GQA decoder and MoE arch at its published
#: widths, B = 2, a 2048-token prompt, 16 greedy tokens; (arch, layers kept):
#: None keeps them all, a number keeps the first that many (f32 weights <= 48 GB)
FAMILY_BATCH, FAMILY_PROMPT = 2, 2048
FAMILY_DEPTHS = [
    ("granite-3-2b", None), ("qwen3-1.7b", None), ("gemma3-4b", None),
    ("deepseek-coder-33b", 20), ("chameleon-34b", 14),
    ("deepseek-moe-16b", 20), ("llama4-scout-17b-a16e", 4), ("jamba-v0.1-52b", 6),
]
FAMILY_WEIGHT_BYTES = 48e9
JAMBA_SSM_LAYERS = 5  # of its first 6 layers (MMMMAM)
#: train_moe: deepseek-moe-16b at published widths cut to 2 layers (layer 0
#: dense, layer 1 MoE), a --fused-server round of 2 clients
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_ARGS = ["--arch", "deepseek-moe-16b", "--fused-server", "--clients", "2",
                  "--population", "4", "--rounds", "2", "--uplink", "float32"]
#: examples: heterogeneous_federation's two fused runs (sync, async) and the
#: kernels the sync one launches once per round; pretrain_e2e's full-width run
#: (photon-125m, 4 rounds of K = 4) and the socket demos, all --fused-server
EXAMPLE_HETERO = {
    "sync": ["--fused-server", "--uplink", "topk", "--rounds", "2"],
    "async": ["--aggregation", "async", "--uplink", "int8", "--rounds", "2", "--fused-server"],
}
EXAMPLE_SYNC_KERNELS = ("server_apply", "topk_mask_ef")
#: the causal ALiBi training pair, which a photon model with hd 64 or 128
#: (reduced photon-75m, photon-125m) launches when it trains in bf16 on the card
ALIBI_PAIR = ("flash_attention_alibi_fwd", "flash_attention_alibi_bwd")
#: the evaluation batches of quickstart's and heterogeneous_federation's
#: ``evaluate_perplexity`` after each round or update
EXAMPLE_EVAL_BATCHES = 2
EXAMPLE_E2E_ARGS = ["--full", "--fused-server"]
E2E_PROFILE_STEPS = 8  # one client's local steps profiled at pretrain_e2e's (B, S)
SOCKET_DEMOS = ("round", "kill-resume", "chaos", "corrupt")
#: the mesh phase: mamba2-1.3b's federated train_4k step on the one-card host
#: mesh at published widths and all 48 layers, the global batch cut 256 -> 2
#: (two micro-batches of 1 x 4096; 8 took ~200 s of the phase and brought the
#: script near its time limit) and τ to the reference's --tau-lowered 1
MESH_ARCH, MESH_BATCH, MESH_TAU = "mamba2-1.3b", 2, 1
#: the round the mesh steps start from: past the inner cosine's 100-step
#: warmup, so the local steps move the params at about lr_max (at round 0
#: the first step's rate is 0)
MESH_ROUND = 100
#: aten ops whose device time the profiled round reports whole (with what
#: they call): the layer slices' backward and the adds that fold it in
MESH_PROFILED_OPS = ("aten::select_backward", "aten::add", "aten::add_", "aten::mul",
                     "aten::bmm", "aten::copy_", "aten::mm")
MESH_UPLINK_KERNELS = {"float32": {"server_apply": 1},
                       "int8": {"server_apply": 1, "int8_quant": 1, "int8_dequant": 1}}
MESH_HOST_SHAPES = "decode_32k,long_500k"
MESH_CLI_TIMEOUT = 600
SOCKET_DEMO_TIMEOUT = 600
#: (kernel, the --uplink that runs it, line of the TPU kernel, why no library call)
CODEC_KERNELS = (
    ("topk_mask_ef", "topk", 236,
     "no single PyTorch call computes both the masked payload and the residual"),
    ("sr_bf16", "bf16", 271, "PyTorch has no stochastic-rounding cast"),
    ("int8_quant", "int8", 303,
     "no single PyTorch call quantizes with a per-(client, leaf) scale table"),
    ("int8_dequant", "int8", 330,
     "no single PyTorch call dequantizes with a per-(client, leaf) scale table"),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sm_clock_hz() -> float:
    """The SM clock's maximum as ``nvidia-smi`` reports it (clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def decode_cases() -> list:
    """``(case, B, Hq, Hkv, S, hd, window)`` of each ``DECODE_LAYERS`` entry,
    from its config and input shape: the shape's global batch and sequence
    (kv_len = S on every row), the arch's heads, head dim and, for a local
    layer, its sliding window."""
    from repro_torch.configs import INPUT_SHAPES, get_config

    cases = []
    for arch, shape, layer in DECODE_LAYERS:
        cfg, sh = get_config(arch), INPUT_SHAPES[shape]
        assert sh.kind == "decode" and (layer is None) == (cfg.sliding_window is None), arch
        cases.append((" ".join(x for x in (arch, shape, layer) if x), sh.global_batch,
                      cfg.n_heads, cfg.n_kv_heads, sh.seq_len, cfg.resolved_head_dim,
                      cfg.sliding_window if layer == "local" else None))
    return cases


def rms_cases() -> list:
    """``(case, R, D)`` of each ``RMS_ROWS`` entry: an input shape's global
    batch x sequence rows, or the serve phase's prefill rows, at the arch's
    d_model."""
    from repro_torch.configs import INPUT_SHAPES, get_config

    cases = []
    for arch, shape in RMS_ROWS:
        sh = INPUT_SHAPES.get(shape)
        rows = sh.global_batch * sh.seq_len if sh else SERVE_BATCH * SSD_SHAPE["S"]
        cases.append((f"{arch} {shape}", rows, get_config(arch).d_model))
    return cases


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call: ``reps`` calls issued back to back between one
    pair of CUDA events, after ``warmup`` calls. The host queues each call
    while the previous one runs, as in a round, so the wrapper's own host
    time is hidden unless it waits for the card."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def without_alibi(launches: dict, layers: int, steps: int, evals: int) -> dict:
    """``launches`` less the ALiBi training pair's, once those are held to
    what a run of a photon model with ``layers`` attention layers makes in
    bf16 on the card: one forward a layer in each of ``steps`` training
    micro-batches and ``evals`` evaluation batches, the backward's two
    kernels a layer in each training micro-batch."""
    want = {ALIBI_PAIR[0]: layers * (steps + evals), ALIBI_PAIR[1]: 2 * layers * steps}
    assert {n: launches.get(n, 0) for n in ALIBI_PAIR} == want, (launches, want)
    return {n: c for n, c in launches.items() if n not in ALIBI_PAIR}


def zero_launches() -> None:
    from repro_torch.kernels import all_kernels

    for fn in all_kernels().values():
        fn.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import all_kernels

    return {name: fn.launches for name, fn in all_kernels().items()}


def phase_build() -> dict:
    from repro_torch.kernels import build as KB

    t0 = time.perf_counter()
    built = KB.build_all()
    seconds = time.perf_counter() - t0
    for source, (path, log) in built.items():
        ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        emit("build", source=source, library=os.path.relpath(path, ROOT), ptxas=ptxas)
    # the bf16 flash and SSD kernels run on the tensor cores: wgmma is HGMMA in the SASS
    hgmma = {}
    for source in ("flash_attention.cu", "ssd_scan.cu"):
        sass = subprocess.run([_cuobjdump(), "-sass", str(built[source][0])],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        hgmma[source] = sum("HGMMA" in line for line in sass.splitlines())
    r = {"seconds": seconds, "flash_attention_sass_HGMMA": hgmma["flash_attention.cu"],
         "ssd_scan_sass_HGMMA": hgmma["ssd_scan.cu"]}
    emit("build", sources=len(built), **r)
    assert all(n > 0 for n in hgmma.values()), ("no HGMMA instruction", hgmma)
    return r


def _cuobjdump() -> str:
    import shutil

    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def _server_apply_case(opt: str, with_noise: bool, gen, dev: str = "cuda",
                       Np: int = NP_PHOTON_75M, C: int = COHORT) -> dict:
    import torch
    from repro_torch.kernels.fedcore import kernel as K

    deltas = torch.randn((C, Np), generator=gen, device=dev) * 1e-2
    w = torch.tensor(([1.0, 2.0, 0.0, 0.5] * C)[:C], device=dev)  # zero-weight clients
    wn = w / w.sum()
    params = torch.randn(Np, generator=gen, device=dev) * 0.02
    # optimizer lanes as one earlier outer step with pseudo-gradient g0 left them
    g0 = torch.randn(Np, generator=gen, device=dev) * 5e-3
    lanes = {"fedavg": [], "fedmom": [g0], "fedadam": [0.1 * g0, 0.01 * g0.square()]}[opt]
    noise = torch.randn(Np, generator=gen, device=dev) * 1e-3 if with_noise else None
    hyper = {
        "fedavg": dict(lr=1.0),
        "fedmom": dict(lr=0.7, momentum=0.9, nesterov=True),
        "fedadam": dict(lr=0.1, momentum=0.9, beta2=0.99, eps=1e-8,
                        bias_corr=(1.0 - 0.9 ** 2, 1.0 - 0.99 ** 2)),
    }[opt]
    n_lanes = len(lanes)

    def run(fn):
        p, ls = params.clone(), [x.clone() for x in lanes]
        norms = fn(deltas, wn, p, ls, opt=opt, noise=noise, **hyper)
        if dev == "cuda":
            torch.cuda.synchronize()
        return p, ls, torch.stack([norms[0], norms[1], *norms[2]])

    # each comparison frees its copies before the next run: at mamba2-1.3b's
    # Np = 1.34 B a (Np,) f32 copy is 5.4 GB
    p_k, l_k, n_k = run(K.server_apply)
    p_k2, l_k2, n_k2 = run(K.server_apply)
    bitwise = bool(torch.equal(n_k, n_k2) and torch.equal(p_k, p_k2)
                   and all(torch.equal(a, b) for a, b in zip(l_k, l_k2)))
    del p_k2, l_k2
    p_p, l_p, n_p = run(K.server_apply_plain)

    scale = max(1.0, float(p_p.abs().max()))
    err_p = float((p_k - p_p).abs().max())
    err_lanes = max([float((a - b).abs().max()) for a, b in zip(l_k, l_p)] or [0.0])
    lane_scale = max([max(1.0, float(b.abs().max())) for b in l_p] or [1.0])
    rel_norms = float(((n_k.double() - n_p.double()).abs() / n_p.double().abs()).max())
    del p_k, l_k, p_p, l_p
    assert err_p <= 1e-6 * scale, (opt, with_noise, "params", err_p)
    assert err_lanes <= 1e-6 * lane_scale, (opt, with_noise, "lanes", err_lanes)
    assert rel_norms <= 1e-5, (opt, with_noise, "norms", rel_norms)
    assert bitwise, (opt, with_noise, "two launches differ")
    assert torch.isfinite(n_k).all(), (opt, with_noise, "non-finite norms")

    p_t, l_t = params.clone(), [x.clone() for x in lanes]
    kernel_ms = time_ms(lambda: K.server_apply(deltas, wn, p_t, l_t, opt=opt, noise=noise,
                                               **hyper), reps=20, warmup=3)
    plain_ms = time_ms(lambda: K.server_apply_plain(deltas, wn, p_t, l_t, opt=opt,
                                                    noise=noise, **hyper), reps=5)
    n_streams = C + 2 + 2 * n_lanes + (1 if with_noise else 0)
    nbytes = 4 * (n_streams * Np + C + 2 + C)  # + weights in, norms out
    flops = Np * (4 * C + 6 + {"fedavg": 2, "fedmom": 6, "fedadam": 14}[opt])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_OPS_PER_S * 1e3
    return {
        "opt": opt, "noise": with_noise, "C": C, "Np": Np,
        "max_abs_err_params": err_p, "max_abs_err_lanes": err_lanes,
        "max_rel_err_norms": rel_norms, "norms_bitwise_across_launches": bitwise,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "kernel_GBps": nbytes / (kernel_ms * 1e-3) / 1e9,
    }


def phase_server_apply() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for opt in ("fedavg", "fedmom", "fedadam"):
        for with_noise in (False, True):
            r = _server_apply_case(opt, with_noise, gen)
            emit("server_apply", **r)
            results[(opt, with_noise)] = r
            torch.cuda.empty_cache()
    # a cohort wider than one launch's 32 register accumulators: two chunks
    # the async flush's (M, Np) buffer; a cohort wider than one launch's
    # 32 register accumulators (two chunks)
    for C in (ASYNC_BUFFER, WIDE_COHORT):
        r = _server_apply_case("fedavg", False, gen, C=C)
        emit("server_apply", **r)
        results[("fedavg", False, C)] = r
        torch.cuda.empty_cache()
    results["poisoned"] = [_poisoned_server_apply_case(*case, gen) for case in POISON_SERVER_CASES]
    return results


def _poison(x, kind: str):
    """``x`` as a Byzantine client's corrupted upload carries it."""
    import torch

    if kind == "x64":
        return x * 64.0
    return torch.full_like(x, {"nan": math.nan, "inf": math.inf}[kind])


def hold_nonfinite(got, want, atol: float = 0.0, rtol: float = 0.0) -> dict:
    """NaN and ±inf at the same positions (inf with its sign), the finite
    values within ``atol + rtol·|want|``; returns the counts and the finite
    max error."""
    import torch

    got, want = got.float(), want.float()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    inf_g, inf_w = torch.isinf(got), torch.isinf(want)
    assert torch.equal(nan_g, nan_w), ("NaN positions differ", int(nan_g.sum()), int(nan_w.sum()))
    assert torch.equal(inf_g, inf_w), ("inf positions differ", int(inf_g.sum()), int(inf_w.sum()))
    assert torch.equal(got[inf_g], want[inf_w]), "inf signs differ"
    fin = ~(nan_w | inf_w)
    diff = (got[fin] - want[fin]).abs()
    assert bool((diff <= atol + rtol * want[fin].abs()).all()), ("finite values", atol, rtol)
    err = float(diff.max()) if bool(fin.any()) else 0.0
    return {"nan": int(nan_w.sum()), "inf": int(inf_w.sum()), "finite": int(fin.sum()),
            "max_abs_err_finite": err}


def _poisoned_server_apply_case(case: str, kind: str, weights, gen,
                                Np: int = NP_PHOTON_75M) -> dict:
    """FedAvg over a (2, Np) buffer whose lane 1 is poisoned, the kernel
    against its plain version: the async flush of a buffer that admitted a
    Byzantine delta (0·NaN = NaN: a zero weight does not hide it)."""
    import torch
    from repro_torch.kernels.fedcore import kernel as K

    deltas = torch.randn((ASYNC_BUFFER, Np), generator=gen, device="cuda") * 1e-2
    deltas[1] = _poison(deltas[1], kind)
    w = torch.tensor(weights, device="cuda")
    wn = w / w.sum()
    params = torch.randn(Np, generator=gen, device="cuda") * 0.02
    outs = []
    for fn in (K.server_apply, K.server_apply_plain):
        p = params.clone()
        norms = fn(deltas, wn, p, [], opt="fedavg", lr=1.0)
        torch.cuda.synchronize()
        outs.append((p, torch.stack([norms[0], norms[1], *norms[2]])))
    (p_k, n_k), (p_p, n_p) = outs
    fin = torch.isfinite(p_p)
    scale = max(1.0, float(p_p[fin].abs().max())) if bool(fin.any()) else 1.0
    held = hold_nonfinite(p_k, p_p, atol=1e-6 * scale)
    held_norms = hold_nonfinite(n_k, n_p, rtol=1e-5)
    r = {"case": case, "C": ASYNC_BUFFER, "Np": Np, "weights": list(weights),
         "params": held, "norms": held_norms, "norms_kernel": [float(x) for x in n_k],
         "norms_plain": [float(x) for x in n_p], "max_abs_err": held["max_abs_err_finite"]}
    emit("server_apply_poisoned", **r)
    del deltas, params, outs
    torch.cuda.empty_cache()
    return r


def _bits(t):
    import torch

    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])


def _codec_case(name: str, kernel, plain, args, nbytes: int, extra=None) -> dict:
    """Kernel against plain, bitwise, then both timed at the given inputs
    (``args[0]`` is the (C, Np) buffer)."""
    import torch

    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    got, want = (got if isinstance(got, tuple) else (got,)), \
        (want if isinstance(want, tuple) else (want,))
    bitwise = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    max_err = max(float((a.float() - b.float()).abs().nan_to_num(0.0, 0.0, 0.0).max())
                  for a, b in zip(got, want))
    assert bitwise, (name, "kernel differs from its plain version", max_err)
    del got, want
    kernel_ms = time_ms(lambda: kernel(*args), reps=20, warmup=3)
    plain_ms = time_ms(lambda: plain(*args), reps=5)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    r = {"C": args[0].shape[0], "Np": args[0].shape[1], "bitwise": bitwise,
         "max_abs_err": max_err,
         "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bytes": nbytes, "bound_ms": bound_ms,
         "bound_by": "bytes", "kernel_GBps": nbytes / (kernel_ms * 1e-3) / 1e9,
         **(extra or {})}
    emit(name, **r)
    torch.cuda.empty_cache()
    return r


def phase_codecs() -> dict:
    """The four uplink codec kernels at photon-75m's packed buffer: the sync
    path's cohort (C = 4) and the async path's single client (C = 1)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.fedcore.ops import BLOCK, FlatSpec

    shapes = photon_leaf_shapes(get_config("photon-75m"))
    n = sum(math.prod(sh) for sh in shapes)
    spec = FlatSpec(shapes=tuple(shapes), n=n, n_pad=-(-n // BLOCK) * BLOCK)
    assert spec.n_pad == NP_PHOTON_75M, (spec.n_pad, NP_PHOTON_75M)
    gen = torch.Generator(device="cuda").manual_seed(1)
    return {C: _codec_cases(C, shapes, spec.offsets + (n,), gen)
            for C in (COHORT, ASYNC_COHORT)}


def _codec_cases(C: int, shapes, offsets, gen) -> dict:
    import torch
    from repro_torch.core.compression import int8_scale
    from repro_torch.kernels.fedcore import FusedTopKCodec, kernel as K

    Np, n = NP_PHOTON_75M, offsets[-1]
    x = torch.zeros((C, Np), device="cuda")
    x[:, :n] = torch.randn((C, n), generator=gen, device="cuda") * 1e-3
    out = {}

    codec = FusedTopKCodec(k_fraction=TOPK_FRACTION)
    thresh = codec.threshold(x, n)
    select_ms = time_ms(lambda: codec.threshold(x, n), reps=5)
    out["topk_mask_ef"] = _codec_case(
        "topk_mask_ef", K.topk_mask_ef, K.topk_mask_ef_plain, (x, thresh), 12 * C * Np + 4 * C,
        {"threshold_select_ms": select_ms, "k": max(1, int(n * TOPK_FRACTION))})
    del thresh

    noise = torch.randint(0, 1 << 16, (C, Np), generator=gen, device="cuda", dtype=torch.int32)
    out["sr_bf16"] = _codec_case("sr_bf16", K.sr_bf16, K.sr_bf16_plain, (x, noise), 10 * C * Np)
    del noise

    scales = torch.stack([int8_scale(x[:, a:b], dim=1) for a, b in zip(offsets, offsets[1:])],
                         dim=1).contiguous()
    out["int8_quant"] = _codec_case("int8_quant", K.int8_quant, K.int8_quant_plain,
                                    (x, scales, offsets), 5 * C * Np,
                                    {"leaves": len(shapes)})
    q = K.int8_quant(x, scales, offsets)
    del x
    out["int8_dequant"] = _codec_case("int8_dequant", K.int8_dequant, K.int8_dequant_plain,
                                      (q, scales, offsets), 5 * C * Np,
                                      {"leaves": len(shapes)})
    if C == ASYNC_COHORT:  # one client's payload with its scale plane corrupted
        out["int8_dequant_poisoned"] = [
            _codec_case("int8_dequant_poisoned", K.int8_dequant, K.int8_dequant_plain,
                        (q, _poison(scales, kind).contiguous(), offsets), 5 * C * Np,
                        {"case": f"scale plane {kind}", "leaves": len(shapes)})
            for kind in POISON_SCALE_CASES]
    return out


def photon_leaf_shapes(cfg):
    """photon's parameter shapes in flatten order, from an abstract init."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    params = build_model(cfg).init(0, device="meta")
    return [tuple(x.shape) for x in tree_leaves(params)]


def phase_check() -> None:
    """One reduced photon round (float32 compute) on the card and on the CPU
    from the same seed must agree: the card's numerics are the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T

    cfg = dataclasses.replace(get_config("photon-75m").reduced(), compute_dtype="float32")
    for uplink in ("float32", "topk"):
        rows = {}
        for dev in ("cpu", "cuda"):
            args = T.parse_args(["--reduced", "--rounds", "1", "--local-steps", "2",
                                 "--clients", "2", "--population", "4", "--seq-len", "64",
                                 "--fused-server", "--uplink", uplink, "--device", dev])
            rows[dev] = T.run(args, cfg=cfg)["history"][0]
        keys = ("train_loss", "pseudo_grad_norm", "global_model_norm", "val_ppl")
        keys += ("uplink_residual_norm",) if uplink == "topk" else ()
        rel = {k: abs(rows["cuda"][k] - rows["cpu"][k]) / abs(rows["cpu"][k]) for k in keys}
        emit("check", uplink=uplink, cuda={k: rows["cuda"][k] for k in keys},
             cpu={k: rows["cpu"][k] for k in keys}, rel_err=rel)
        assert all(math.isfinite(rows["cuda"][k]) for k in keys), rows["cuda"]
        assert max(rel.values()) <= 1e-3, (uplink, rel)
    # two async updates: the simulated timeline is the same on both devices,
    # the numbers agree as the sync round's do
    for uplink in ("float32", "topk"):
        hist = {}
        for dev in ("cpu", "cuda"):
            args = T.parse_args(["--reduced", "--rounds", "2", "--local-steps", "2",
                                 "--clients", "4", "--population", "8", "--seq-len", "64",
                                 "--fused-server", "--aggregation", "async",
                                 "--straggler-profile", "heavy", "--uplink", uplink,
                                 "--device", dev])
            hist[dev] = T.run(args, cfg=cfg)["history"]
        keys = ("train_loss", "pseudo_grad_norm", "global_model_norm", "val_ppl")
        keys += ("uplink_residual_norm",) if uplink == "topk" else ()
        for cpu, card in zip(hist["cpu"], hist["cuda"]):
            rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in keys}
            emit("check", aggregation="async", uplink=uplink, update=card["update"],
                 sim_time=card["sim_time"], cuda={k: card[k] for k in keys},
                 cpu={k: cpu[k] for k in keys}, rel_err=rel)
            for k in ("sim_time", "buffer_fill", "staleness_mean", "deltas_admitted"):
                assert card[k] == cpu[k], (uplink, k, card[k], cpu[k])
            assert all(math.isfinite(card[k]) for k in keys), card
            assert max(rel.values()) <= 1e-3, (uplink, rel)
        assert len(hist["cuda"]) == len(hist["cpu"]) == 2


#: the kernels each train phase must launch once per round, and no other
TRAIN_KERNELS = {
    "float32": ("server_apply",),
    "topk": ("server_apply", "topk_mask_ef"),
    "bf16": ("server_apply", "sr_bf16"),
    "int8": ("server_apply", "int8_quant", "int8_dequant"),
}


def phase_train(uplink: str) -> dict:
    import torch
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    args = T.parse_args(["--arch", "photon-75m", "--fused-server", "--rounds", "2",
                         "--uplink", uplink, "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = T.run(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()

    tokens_per_round = args.clients * args.local_steps * args.batch * args.seq_len
    for row in out["history"]:
        emit("train", uplink=uplink, round=row["round"], loss=row["train_loss"],
             val_ppl=row["val_ppl"], pseudo_grad_norm=row["pseudo_grad_norm"],
             global_model_norm=row["global_model_norm"], seconds=row["seconds"],
             tokens_per_s=tokens_per_round / row["seconds"],
             uplink_residual_norm=row.get("uplink_residual_norm"),
             uplink_bytes_per_client=row["uplink_bytes_per_client"],
             uplink_compression_ratio=row["uplink_compression_ratio"])
    leaves = tree_leaves(out["state"]["params"])
    n_params = sum(x.numel() for x in leaves)
    emit("train", uplink=uplink, total_seconds=seconds, launches=launches, n_params=n_params,
         peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9)
    # photon-75m's 74,100,992 params fill exactly the flat length the kernel
    # phases ran at, once padded to the reference's 8192-element blocks
    assert -(-n_params // 8192) * 8192 == NP_PHOTON_75M, n_params
    assert all(bool(torch.isfinite(x).all()) for x in leaves), "non-finite params"
    for row in out["history"]:
        assert math.isfinite(row["train_loss"]) and math.isfinite(row["val_ppl"]), row
        if uplink == "topk":
            assert math.isfinite(row["uplink_residual_norm"]), row
    want = {name: args.rounds if name in TRAIN_KERNELS[uplink] else 0 for name in launches}
    assert launches == want, (uplink, launches, want)
    del out
    torch.cuda.empty_cache()
    return launches


def phase_train_async(uplink: str) -> dict:
    """photon-75m's async path; each kernel's launches must equal the driver's
    counter that ``ASYNC_KERNEL_COUNTERS`` names for it, and no other kernel
    may launch."""
    import torch
    from repro_torch.core.aggregator import ASYNC_KERNEL_COUNTERS
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    args = T.parse_args(["--arch", "photon-75m", "--aggregation", "async", "--fused-server",
                         "--rounds", "3", "--straggler-profile", "heavy",
                         "--dropout-rate", "0.1", "--uplink", uplink, "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = T.run(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    drv = out["driver"]
    counts = {"n_flushes": drv.n_flushes, "n_client_phases": drv.n_client_phases,
              "n_admissions": drv.n_admissions}

    tokens_per_delta = args.local_steps * args.batch * args.seq_len
    for row in out["history"]:
        emit("train_async", uplink=uplink, update=row["update"], seconds=row["seconds"],
             deltas=row["buffer_fill"],
             tokens_per_s=row["buffer_fill"] * tokens_per_delta / row["seconds"],
             staleness_mean=row["staleness_mean"], staleness_max=row["staleness_max"],
             loss=row["train_loss"], val_ppl=row["val_ppl"],
             pseudo_grad_norm=row["pseudo_grad_norm"], sim_time=row["sim_time"],
             wallclock_speedup=row["wallclock_speedup"],
             uplink_bytes_per_client=row["uplink_bytes_per_client"])
    # one more update (no validation) under the profiler: the device's busy
    # share of the event loop — client phases, admissions, the flush; then
    # one more, its parts timed apart
    prof = profile_device(lambda: drv.run_updates(1))
    parts = async_update_parts(drv, out, args)
    leaves = tree_leaves(out["state"]["params"])
    emit("train_async", uplink=uplink, total_seconds=seconds, launches=launches, **counts,
         dispatched=drv.n_dispatched, sim_time=drv.sim_time,
         n_params=sum(x.numel() for x in leaves), peak_mem_GB=peak / 1e9,
         profiled_update_device_ms=prof["device_ms"],
         profiled_update_wall_ms=prof["profiled_wall_ms"],
         busy_share=prof["device_ms"] / prof["profiled_wall_ms"],
         top_kernels_ms=prof["top_kernels_ms"], update_parts_ms=parts)
    assert all(bool(torch.isfinite(x).all()) for x in leaves), "non-finite params"
    for row in out["history"]:
        assert math.isfinite(row["train_loss"]) and math.isfinite(row["val_ppl"]), row
    assert len(out["history"]) == args.rounds and counts["n_flushes"] == args.rounds, counts
    counters = ASYNC_KERNEL_COUNTERS[uplink]
    want = {name: counts[counters[name]] if name in counters else 0 for name in launches}
    assert launches == want, (uplink, launches, want)
    del out, drv
    torch.cuda.empty_cache()
    return launches


def _run_counted(argv):
    """``repro_torch.launch.train`` with ``argv`` on the card, the kernel
    counts zeroed just before and read just after; ``(out, launches,
    seconds, peak bytes)``."""
    import torch
    from repro_torch.launch import train as T

    args = T.parse_args(argv + ["--device", "cuda"])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = T.run(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, read_launches(), seconds, torch.cuda.max_memory_allocated()


def phase_train_tiled() -> dict:
    """photon-75m's sync round at K = 16, flat and in tiles of 4 (and the
    trimmed fold in tiles of 4): none of these paths launches a kernel; the
    tiled peak must follow the tile, not K. Then a one-tile round is held
    bitwise to the flat one, and the fold's sort is timed."""
    import torch
    from repro_torch.tree import tree_leaves

    runs = {}
    tile = ["--cohort-tile", str(COHORT_TILE)]
    for name, extra in (("flat", []), ("tiled", tile),
                        ("tiled_trimmed", tile + ["--robust-agg", "trimmed"])):
        out, launches, seconds, peak = _run_counted(TILED_ARGS + extra)
        hist = out["history"]
        for row in hist:
            emit("train_tiled", run=name, round=row["round"], seconds=row["seconds"],
                 loss=row["train_loss"], val_ppl=row["val_ppl"],
                 pseudo_grad_norm=row["pseudo_grad_norm"])
        runs[name] = {"round_seconds": [row["seconds"] for row in hist], "peak_mem_GB": peak / 1e9,
                      "val_ppl": hist[-1]["val_ppl"], "total_seconds": seconds,
                      "launches": launches}
        emit("train_tiled", run=name, **runs[name])
        assert all(v == 0 for v in launches.values()), (name, launches)
        assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(out["state"]["params"]))
        assert all(math.isfinite(r["train_loss"]) and math.isfinite(r["val_ppl"]) for r in hist)
        del out
    # the one-tile identity on the card: K = 4 flat, K = 4 in one tile, and
    # flat again (the card's own run-to-run determinism)
    one = ["--arch", "photon-75m", "--clients", "4", "--population", "8", "--local-steps", "4",
           "--rounds", "1", "--uplink", "float32"]
    ident = {}
    for name, extra in (("flat", []), ("one_tile", ["--cohort-tile", "4"]), ("flat_again", [])):
        out, launches, _, peak = _run_counted(one + extra)
        ident[name] = (out["history"][0]["train_loss"], tree_leaves(out["state"]["params"]), peak)
        assert all(v == 0 for v in launches.values()), (name, launches)
        del out
    checksum = {k: float(sum(x.double().sum() for x in v[1])) for k, v in ident.items()}
    same = {k: ident[k][0] == ident["flat"][0]
            and all(torch.equal(a, b) for a, b in zip(ident[k][1], ident["flat"][1]))
            for k in ("one_tile", "flat_again")}
    r = {"loss": {k: v[0] for k, v in ident.items()}, "params_checksum": checksum,
         "bitwise_vs_flat": same, "peak_mem_GB_K4": ident["flat"][2] / 1e9}
    emit("train_tiled", check="one tile == flat, K = 4", **r)
    assert same["flat_again"], "two flat rounds on the card differ"
    assert same["one_tile"], "the one-tile round differs from the flat round"
    del ident
    # the tiled peak follows the tile: the K = 4 round's peak plus the Σ w·Δ
    # row (and, trimmed, the fold's buffers and its sort), far under flat K = 16
    k4 = r["peak_mem_GB_K4"]
    assert runs["tiled"]["peak_mem_GB"] < k4 + 1.0, (runs["tiled"], k4)
    assert runs["tiled_trimmed"]["peak_mem_GB"] < runs["flat"]["peak_mem_GB"], runs
    runs["one_tile"] = r
    runs["fold_sort"] = _fold_sort_times()
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _fold_sort_times() -> dict:
    """Device ms of one ``tile_fold_update`` (the sort along the lane axis
    of the (k + C_tile, N) concatenation, per leaf) at photon-75m's leaves,
    K = 16 in tiles of 4: the trimmed depth k = 1 and the median's k = 9."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.robust import tile_fold_init, tile_fold_size, tile_fold_update
    from repro_torch.models import build_model

    from repro_torch.tree import tree_leaves, tree_map

    params = build_model(get_config("photon-75m")).init(0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    deltas = tree_map(lambda x: torch.randn((COHORT_TILE,) + tuple(x.shape), generator=gen,
                                            device="cuda") * 1e-3, params)
    admit = torch.ones(COHORT_TILE, dtype=torch.bool, device="cuda")
    n = sum(x.numel() for x in tree_leaves(params))
    out = {}
    for rule in ("trimmed", "median"):
        k = tile_fold_size(rule, 0.1, 16)
        fold = tile_fold_init(params, k)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = time_ms(lambda: tile_fold_update(fold, deltas, admit), reps=3, warmup=1)
        rows = k + COHORT_TILE
        out[rule] = {"k": k, "rows": rows, "N": n, "ms": ms,
                     "transient_GB": (torch.cuda.max_memory_allocated() - base) / 1e9,
                     # the fold reads its two (k, N) buffers and the tile once and
                     # writes the buffers and the total: a bytes bound for the sort
                     "bytes_bound_ms": 4 * n * (2 * k + COHORT_TILE + 2 * k + 2)
                     / HBM_BYTES_PER_S * 1e3}
        emit("train_tiled", fold_sort=rule, **out[rule])
        del fold
    del params, deltas
    torch.cuda.empty_cache()
    return out


def phase_train_byzantine(uplink: str) -> dict:
    """The async Byzantine run with --rollback at full width: the updates
    that roll back are the reference CLI's (update 3 only), each fedcore
    kernel launches as often as AsyncFederationDriver counts, the final params are
    finite."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.aggregator import ASYNC_KERNEL_COUNTERS
    from repro_torch.tree import tree_leaves

    ck = tempfile.mkdtemp(prefix="chip_smoke_byz_")
    try:
        out, launches, seconds, peak = _run_counted(BYZANTINE_ARGS + ["--uplink", uplink,
                                                                      "--ckpt-dir", ck])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    drv = out["driver"]
    counts = {"n_flushes": drv.n_flushes, "n_client_phases": drv.n_client_phases,
              "n_admissions": drv.n_admissions}
    for row in out["history"]:
        emit("train_byzantine", uplink=uplink, update=row["update"],
             rolled_back=row["rolled_back"], pseudo_grad_norm=row["pseudo_grad_norm"],
             nonfinite_deltas=row["nonfinite_deltas"], val_ppl=row["val_ppl"],
             seconds=row["seconds"])
    rolled = [row["rolled_back"] for row in out["history"]]
    leaves = tree_leaves(out["state"]["params"])
    finite = all(bool(torch.isfinite(x).all()) for x in leaves)
    emit("train_byzantine", uplink=uplink, launches=launches, **counts, rolled_back=rolled,
         robust=drv.robust_state.state_dict(), total_seconds=seconds, peak_mem_GB=peak / 1e9,
         final_params_finite=finite)
    assert rolled == BYZANTINE_ROLLED_BACK, (uplink, rolled)
    assert finite, "non-finite params after the rollback"
    counters = ASYNC_KERNEL_COUNTERS[uplink]
    want = {name: counts[counters[name]] if name in counters else 0 for name in launches}
    assert launches == want, (uplink, launches, want)
    del out, drv
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_centralized() -> dict:
    """The paper's baseline on this card: ``centralized_step`` at photon-75m's
    full width on a global batch of K·B = 16 rows of 128 tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import InnerOptConfig, centralized_step, init_centralized_state
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config("photon-75m")
    model = build_model(cfg)
    inner = InnerOptConfig(warmup_steps=1, total_steps=CENTRAL_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    state = init_centralized_state(inner, model.init(0, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    seconds, losses = [], []
    for _ in range(CENTRAL_STEPS):
        toks = torch.randint(0, cfg.vocab_size, (CENTRAL_BATCH, CENTRAL_SEQ), generator=gen,
                             device="cuda", dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = centralized_step(model.loss, inner, state, {"tokens": toks})
        losses.append(float(metrics["loss"]))  # waits for the device
        seconds.append(time.perf_counter() - t0)
    launches = read_launches()
    tokens = CENTRAL_BATCH * CENTRAL_SEQ
    r = {"steps": CENTRAL_STEPS, "batch": CENTRAL_BATCH, "seq_len": CENTRAL_SEQ,
         "step_seconds": seconds, "loss": losses,
         "tokens_per_s": tokens * (CENTRAL_STEPS - 1) / sum(seconds[1:]),
         "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9, "launches": launches}
    emit("centralized", **r)
    assert all(math.isfinite(x) for x in losses), losses
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(state["params"]))
    assert state["step"] == CENTRAL_STEPS and all(v == 0 for v in launches.values())
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# The deployment layer: controller-picked widths and the socket runtime
# ---------------------------------------------------------------------------


#: the bytes each codec kernel moves over a (C, Np) buffer (as in _codec_cases)
CODEC_BYTES = {"topk_mask_ef": lambda C, Np: 12 * C * Np + 4 * C,
               "int8_quant": lambda C, Np: 5 * C * Np,
               "int8_dequant": lambda C, Np: 5 * C * Np}


class _KernelInputs:
    """Records what the fedcore wrappers are given while installed: the
    (C, Np) of every ``server_apply`` launch (``calls``: the widths a
    controller or a CLI picked), and for each codec kernel the shape of every
    launch with a copy of the inputs of the first launch at each shape, so
    that they can be held to the plain version afterwards. The calls go
    through ``ops.K``; the wrappers count their launches as before."""

    def __init__(self):
        self.server_apply = []  # (C, Np) per launch
        self.codec_shapes = {name: [] for name in CODEC_BYTES}
        self.codec_args = {name: {} for name in CODEC_BYTES}  # shape -> cloned args

    def __enter__(self):
        from repro_torch.kernels.fedcore import ops

        self._ops, self._K, rec = ops, ops.K, self
        K = self._K

        def clone(a):
            return a.clone() if hasattr(a, "clone") else a

        class Proxy:
            def __getattr__(self, name):
                return getattr(K, name)

            def server_apply(self, deltas2d, *args, **kw):
                rec.server_apply.append(tuple(deltas2d.shape))
                return K.server_apply(deltas2d, *args, **kw)

        def codec(name):
            def call(*args):
                key = (*args[0].shape, *(tuple(args[2]) if len(args) > 2 else ()))
                rec.codec_shapes[name].append(key)
                if key not in rec.codec_args[name]:
                    rec.codec_args[name][key] = tuple(clone(a) for a in args)
                return getattr(K, name)(*args)
            return staticmethod(call)

        for name in CODEC_BYTES:
            setattr(Proxy, name, codec(name))
        ops.K = Proxy()
        return self

    def __exit__(self, *exc):
        self._ops.K = self._K

    @property
    def calls(self):
        """The cohort width C of every ``server_apply`` launch."""
        return [C for C, _ in self.server_apply]

    def held(self, phase: str, gen) -> dict:
        """Each codec kernel against its plain version, bitwise, on the inputs
        the run gave it (one case per shape), and ``server_apply`` at every
        (C, Np) of the run."""
        import torch
        from repro_torch.kernels.fedcore import kernel as K

        out = {}
        for name, cases in self.codec_args.items():
            out[name] = []
            for key, args in cases.items():
                C, Np = args[0].shape
                extra = {"leaves": len(args[2]) - 1} if len(args) > 2 else {}
                r = _codec_case(name, getattr(K, name), getattr(K, name + "_plain"), args,
                                CODEC_BYTES[name](C, Np), {"run": phase, **extra})
                out[name].append({k: r[k] for k in ("C", "Np", "bitwise", "max_abs_err",
                                                    "kernel_ms", "plain_ms", "bound_ms",
                                                    "bound_by")} | extra)
            cases.clear()
            torch.cuda.empty_cache()
        by_np = {}
        for C, Np in self.server_apply:
            by_np.setdefault(Np, []).append(C)
        out["server_apply"] = [case for Np, Cs in sorted(by_np.items())
                               for case in _widths_held(Cs, phase, gen, Np=Np).values()]
        return out


def _widths_held(widths, phase: str, gen, Np: int = NP_PHOTON_75M) -> dict:
    """``server_apply`` against its plain version at every width a run gave it."""
    import torch

    out = {}
    for C in sorted(set(widths)):
        r = _server_apply_case("fedavg", False, gen, C=C, Np=Np)
        out[C] = {k: r[k] for k in ("C", "Np", "max_abs_err_params", "max_rel_err_norms",
                                    "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
        emit(phase, server_apply_held=out[C])
        torch.cuda.empty_cache()
    return out


def phase_train_governed(uplink: str) -> dict:
    """photon-75m's async path with ``--control staleness``: the governor
    resizes the buffer M on powers of two (``GOVERNED_WIDTHS``), so each
    flush's ``server_apply`` runs at the width it picked; every width is held
    to the plain version, and the launches to the driver's counters."""
    import torch
    from repro_torch.core.aggregator import ASYNC_KERNEL_COUNTERS
    from repro_torch.tree import tree_leaves

    with _KernelInputs() as w:
        out, launches, seconds, peak = _run_counted(GOVERNED_ARGS + ["--uplink", uplink])
    drv = out["driver"]
    counts = {"n_flushes": drv.n_flushes, "n_client_phases": drv.n_client_phases,
              "n_admissions": drv.n_admissions}
    alpha = float(GOVERNED_ARGS[GOVERNED_ARGS.index("--staleness-alpha") + 1])
    for row, C in zip(out["history"], w.calls):
        emit("train_governed", uplink=uplink, update=row["update"], M=C, alpha=alpha,
             server_apply_C=C, buffer_fill=row["buffer_fill"],
             staleness_mean=row["staleness_mean"], staleness_max=row["staleness_max"],
             knob_buffer_size=row.get("knob_buffer_size"),
             knob_staleness_alpha=row.get("knob_staleness_alpha"), seconds=row["seconds"],
             loss=row["train_loss"], val_ppl=row["val_ppl"])
        alpha = row.get("knob_staleness_alpha", alpha)
    leaves = tree_leaves(out["state"]["params"])
    r = {"uplink": uplink, "widths": w.calls, "launches": launches, **counts,
         "control_history": drv.controller.history, "total_seconds": seconds,
         "peak_mem_GB": peak / 1e9}
    emit("train_governed", **r)
    assert w.calls == GOVERNED_WIDTHS, (uplink, w.calls)
    assert all(bool(torch.isfinite(x).all()) for x in leaves), "non-finite params"
    assert all(math.isfinite(row["train_loss"]) for row in out["history"])
    counters = ASYNC_KERNEL_COUNTERS[uplink]
    want = {name: counts[counters[name]] if name in counters else 0 for name in launches}
    assert launches == want and counts["n_flushes"] == len(w.calls), (uplink, launches, want)
    del out, drv
    gc.collect()
    r["held"] = _widths_held(w.calls, "train_governed",
                             torch.Generator(device="cuda").manual_seed(11))
    return r


def phase_train_cohort() -> dict:
    """photon-75m's sync path with ``--control cohort``: the tuner widens K
    (``COHORT_WIDTHS``), so each round's ``server_apply`` runs at the K it
    picked; every width is held to the plain version. Then ``--control
    static`` is bitwise the run without the flag on this card."""
    import torch
    from repro_torch.tree import tree_leaves

    with _KernelInputs() as w:
        out, launches, seconds, peak = _run_counted(COHORT_ARGS)
    hist = out["history"]
    for row, C in zip(hist, w.calls):
        emit("train_cohort", round=row["round"], K=len(row["selected"].split(",")),
             server_apply_C=C, effective_k=row["effective_k"],
             knob_clients_per_round=row.get("knob_clients_per_round"),
             knob_deadline=row.get("knob_deadline"), seconds=row["seconds"],
             loss=row["train_loss"], val_ppl=row["val_ppl"])
    r = {"widths": w.calls, "launches": launches, "total_seconds": seconds,
         "peak_mem_GB": peak / 1e9,
         "control_history": out["aggregator"].controller.history}
    emit("train_cohort", **r)
    assert w.calls == COHORT_WIDTHS, w.calls
    assert launches == {name: len(hist) if name == "server_apply" else 0 for name in launches}
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(out["state"]["params"]))
    del out
    gc.collect()
    # --control static against no flag, two rounds each: rows and params bitwise
    static = []
    for extra in (["--control", "static"], []):
        o, _, _, _ = _run_counted(COHORT_STATIC_ARGS + extra)
        static.append(([{k: v for k, v in row.items() if k != "seconds"} for row in o["history"]],
                       [x.cpu() for x in tree_leaves(o["state"]["params"])]))
        del o
    same = static[0][0] == static[1][0] and all(
        torch.equal(a, b) for a, b in zip(static[0][1], static[1][1]))
    r["static_bitwise_uncontrolled"] = same
    emit("train_cohort", static_bitwise_uncontrolled=same)
    assert same, "--control static differs from the uncontrolled run"
    del static
    gc.collect()
    r["held"] = _widths_held(w.calls, "train_cohort",
                             torch.Generator(device="cuda").manual_seed(12))
    return r


def _quick_worker():
    """``ClientWorker`` that gives up 5 s after losing its server (the CLI's
    default waits a minute): a worker still training an in-flight slot when
    the run ends finds the server gone."""
    from repro_torch.runtime import Backoff, ClientWorker

    class QuickWorker(ClientWorker):
        def __init__(self, *a, **kw):
            super().__init__(*a, backoff=Backoff(give_up_after=5.0), **kw)

    return QuickWorker


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _socket_run(uplink: str, port: int) -> dict:
    """The socket runtime in this process: the CLI's ``--role server`` on the
    main thread and two ``--role client`` workers on threads, all on the
    card. The server's backend and driver are instrumented subclasses that
    read, at each flush, the wall clock, the wire bytes each way, the host
    seconds spent framing and the device memory."""
    import threading

    import torch
    from repro_torch.launch import train as T
    from repro_torch.obs import Tracer
    from repro_torch.runtime import FederationDriver, SocketBackend

    per_update = []

    class Backend(SocketBackend):
        def __init__(self, *a, tracer=None, **kw):  # a tracer for the byte counters
            super().__init__(*a, tracer=tracer or Tracer(proc="server"), **kw)

    class Driver(FederationDriver):
        def _flush_row(self, flush_metrics, deadline=False):
            row = super()._flush_row(flush_metrics, deadline)
            c = self.backend.tracer.snapshot()["counters"]
            per_update.append({"bytes_tx": c.get("bytes_tx", 0.0),
                               "bytes_rx": c.get("bytes_rx", 0.0),
                               "frame_s": self.backend.clock.seconds,
                               "mem_GB": torch.cuda.memory_allocated() / 1e9})
            return row

    base = SOCKETS_ARGS + ["--uplink", uplink, "--runtime", "sockets", "--port", str(port)]
    workers = {}

    def work(name):
        workers[name] = T.run(T.parse_args(base + ["--role", "client", "--worker-id", name,
                                                    "--device", "cuda", "--io-timeout", "120"]))

    saved = T.SocketBackend, T.FederationDriver, T.ClientWorker
    T.SocketBackend, T.FederationDriver, T.ClientWorker = Backend, Driver, _quick_worker()
    threads = [threading.Thread(target=work, args=(f"w{i}",), daemon=True) for i in range(2)]
    try:
        for t in threads:
            t.start()  # they back off until the server listens
        out, _, seconds, peak = _run_counted(base + ["--role", "server"])
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a worker thread did not finish"
        # read after the workers finished: a worker may still encode an
        # in-flight slot after the server's last update
        launches = read_launches()
    finally:
        T.SocketBackend, T.FederationDriver, T.ClientWorker = saved
    prev = {"bytes_tx": 0.0, "bytes_rx": 0.0, "frame_s": 0.0}
    rows = []
    for row, u in zip(out["history"], per_update):
        rows.append({"update": row["update"], "wall_s": row["seconds"],
                     "server_to_workers_bytes": u["bytes_tx"] - prev["bytes_tx"],
                     "workers_to_server_bytes": u["bytes_rx"] - prev["bytes_rx"],
                     "server_frame_s": u["frame_s"] - prev["frame_s"],
                     "device_mem_GB": u["mem_GB"]})
        prev = u
    return {"out": out, "launches": launches, "seconds": seconds, "peak": peak,
            "per_update": rows,
            "workers": {n: {"completed": r["completed"],
                            "client_phases": r["worker"].n_client_phases,
                            "frame_s": r["worker"].clock.seconds} for n, r in workers.items()}}


def _cli_processes(uplink: str, ck: str) -> dict:
    """One ``--role server`` and two ``--role client`` processes of this
    script's ``--cli-process`` mode, each with a timeout; returns their
    reports (peak device memory, framing seconds, launches)."""
    port = _free_port()
    base = SOCKETS_ARGS + ["--uplink", uplink, "--runtime", "sockets", "--port", str(port),
                           "--device", "cuda"]
    cmds = {"server": base + ["--role", "server", "--log", os.path.join(ck, "sockets.csv")]}
    for i in range(2):
        cmds[f"w{i}"] = base + ["--role", "client", "--worker-id", f"w{i}", "--io-timeout", "120"]
    procs = {name: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cli-process"]
                                    + argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, cwd=ROOT)
             for name, argv in cmds.items()}
    reports, logs = {}, {}
    try:
        for name in ("server", "w0", "w1"):
            logs[name], _ = procs[name].communicate(timeout=300 if name == "server" else 60)
            assert procs[name].returncode == 0, (name, logs[name][-3000:])
            line = [l for l in logs[name].splitlines() if l.startswith("CLI_PROCESS ")][-1]
            reports[name] = json.loads(line[len("CLI_PROCESS "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return reports


def cli_process(argv) -> int:
    """``chip_smoke.py --cli-process ARGS``: ``repro_torch.launch.train`` with
    ARGS in this process, then one ``CLI_PROCESS {json}`` line: its peak
    device memory, framing seconds and kernel launches."""
    import torch
    from repro_torch.launch import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    T.ClientWorker = _quick_worker()
    out = T.run(T.parse_args(argv))
    r = {"peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9, "launches": read_launches()}
    if "worker" in out:
        r.update(completed=out["completed"], client_phases=out["worker"].n_client_phases,
                 frame_s=out["worker"].clock.seconds)
    else:
        drv = out["driver"]
        r.update(updates=len(out["history"]), frame_s=drv.backend.clock.seconds,
                 n_flushes=drv.n_flushes, n_admissions=drv.n_admissions)
    print("CLI_PROCESS " + json.dumps(r), flush=True)
    return 0


def phase_train_sockets() -> dict:
    """photon-75m's async path over the socket runtime at full width, float32
    and int8: bitwise the in-process ``AsyncFederationDriver`` run from the
    same seeds (every row but the wall clock, and the final params), the
    launches held (``int8_quant`` once per executed assignment on the
    workers, ``int8_dequant`` once per admission and ``server_apply`` once per
    flush on the server); then one real run of three processes through the
    CLI, whose last row is the in-process CLI's."""
    import shutil
    import tempfile

    import torch
    from repro_torch.tree import tree_leaves

    results = {}
    ck = tempfile.mkdtemp(prefix="chip_smoke_sockets_")
    try:
        for uplink in ("float32", "int8"):
            ref, ref_launches, ref_s, ref_peak = _run_counted(
                SOCKETS_ARGS + ["--uplink", uplink, "--log", os.path.join(ck, f"in_{uplink}.csv")])
            ref_rows = [{k: v for k, v in row.items() if k != "seconds"} for row in ref["history"]]
            ref_params = [x.cpu() for x in tree_leaves(ref["state"]["params"])]
            ref_seconds = [row["seconds"] for row in ref["history"]]
            del ref
            gc.collect()
            torch.cuda.empty_cache()
            s = _socket_run(uplink, _free_port())
            drv = s["out"]["driver"]
            rows = [{k: v for k, v in row.items() if k != "seconds"} for row in s["out"]["history"]]
            params = [x.cpu() for x in tree_leaves(s["out"]["state"]["params"])]
            bitwise = rows == ref_rows and all(torch.equal(a, b)
                                               for a, b in zip(params, ref_params))
            executed = sum(w["client_phases"] for w in s["workers"].values())
            for u, r in enumerate(s["per_update"]):
                emit("train_sockets", uplink=uplink, **r, inproc_seconds=ref_seconds[u])
            r = {"uplink": uplink, "bitwise_vs_inproc": bitwise, "launches": s["launches"],
                 "inproc_launches": ref_launches, "n_flushes": drv.n_flushes,
                 "n_admissions": drv.n_admissions, "executed_assignments": executed,
                 "workers": s["workers"], "server_frame_s": drv.backend.clock.seconds,
                 "total_seconds": s["seconds"], "inproc_total_seconds": ref_s,
                 "peak_mem_GB_server_and_workers": s["peak"] / 1e9,
                 "inproc_peak_mem_GB": ref_peak / 1e9}
            emit("train_sockets", **r)
            assert bitwise, (uplink, "the socket run differs from the in-process run")
            want = {name: 0 for name in s["launches"]}
            want["server_apply"] = drv.n_flushes
            if uplink == "int8":
                want["int8_quant"], want["int8_dequant"] = executed, drv.n_admissions
            assert s["launches"] == want, (uplink, s["launches"], want)
            results[uplink] = r
            del s, drv, params, ref_params
            gc.collect()
            torch.cuda.empty_cache()
        reports = _cli_processes("int8", ck)
        with open(os.path.join(ck, "sockets.csv")) as f:
            got = list(csv.DictReader(f))[-1]
        with open(os.path.join(ck, "in_int8.csv")) as f:
            want = list(csv.DictReader(f))[-1]
        same = {k: got[k] == want[k] for k in want if k != "seconds"}
        emit("train_sockets", processes=reports, last_row_equal=all(same.values()))
        assert all(same.values()), [k for k, v in same.items() if not v]
        assert reports["server"]["launches"]["server_apply"] == reports["server"]["n_flushes"]
        assert reports["server"]["launches"]["int8_dequant"] == reports["server"]["n_admissions"]
        for name in ("w0", "w1"):
            assert reports[name]["launches"]["int8_quant"] == reports[name]["client_phases"]
        results["processes"] = reports
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    return results


def async_update_parts(drv, out, args) -> dict:
    """Wall ms of one async update by part, each part between two device
    syncs: the client phases (``run_clients``), the admissions (decode and
    buffer write), the flush, the rest of the event loop (batches, the loss
    and residual-norm reads, dispatch, the row), then one validation as the
    launcher runs it after each update."""
    import torch
    from repro_torch.core import aggregator as A
    from repro_torch.data import validation_stream
    from repro_torch.metrics import evaluate_perplexity

    parts = {"client_phases": 0.0, "admissions": 0.0, "flush": 0.0}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] += (time.perf_counter() - t0) * 1e3
            return r
        return call

    run_clients = A.run_clients
    A.run_clients = timed("client_phases", run_clients)
    drv.admit, drv.flush = timed("admissions", drv.admit), timed("flush", drv.flush)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.run_updates(1)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        A.run_clients = run_clients
        del drv.admit, drv.flush
    stream = validation_stream(args.seq_len, out["config"].vocab_size, args.heterogeneous)
    t0 = time.perf_counter()
    evaluate_perplexity(out["model"], drv.state["params"], stream, batches=args.eval_batches,
                        batch_size=args.batch, device=drv.device)
    torch.cuda.synchronize()
    return dict(parts, rest=total - sum(parts.values()), update=total,
                validation=(time.perf_counter() - t0) * 1e3)


# ---------------------------------------------------------------------------
# The SSD chunk scan and the serving path
# ---------------------------------------------------------------------------


def ssd_bound(B, S, nh, hd, G, ds, chunk, itemsize: int = 2):
    """(bytes, flops) the chunk scan must move and do: x, Bm, Cm and y in
    ``itemsize`` bytes, dt, A and both states in f32, each read or written
    once; the products at 2 flops per multiply-add: C·Bᵀ once per
    (b, g, chunk), since it does not depend on the head, and per (b, h, chunk)
    (C·Bᵀ∘L)·dx, C·Sᵀ and the state update. L is zero above the diagonal, so
    both intra-chunk products count only the entries j ≤ i."""
    nbytes = itemsize * (2 * B * nh * S * hd + 2 * B * G * S * ds) \
        + 4 * (B * nh * S + nh + 2 * B * nh * hd * ds)
    tri = chunk * (chunk + 1) // 2
    flops = 2 * (S // chunk) * (B * G * tri * ds + B * nh * (tri * hd + 2 * chunk * hd * ds))
    return nbytes, flops


def ssd_case(S: int, gen, ragged: bool = False, dtype=None, shape=None) -> dict:
    """Kernel against plain version on the card at mamba2-1.3b's layer shape
    (or ``shape``), bf16 unless ``dtype`` says otherwise. y: |Δ| ≤
    rtol·|y| + 1e-5·max|y|, rtol 2⁻⁷ for bf16 (one bf16 ulp: both sides sum in
    f32 in other orders, then round), 0 for f32; final state: |Δ| ≤
    1e-5·max|S|. Bound: bytes over HBM, or flops over the peak of the units
    the dtype's kernel runs on (bf16 tensor cores, or f32 CUDA cores)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import kernel as SK, ops

    dtype = dtype or torch.bfloat16
    sh = dict(shape or SSD_SHAPE, S=S)
    B, nh, hd, G, ds, chunk = (sh[k] for k in ("B", "nh", "hd", "G", "ds", "chunk"))
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x = rnd(B, S, nh, hd).to(dtype)  # model layout, as ssm_block hands it to ops.ssd
    dt = F.softplus(rnd(B, S, nh) - 1.0)
    A = -torch.exp(0.5 * rnd(nh))
    Bm, Cm = rnd(B, S, G, ds).to(dtype), rnd(B, S, G, ds).to(dtype)
    init = 0.1 * rnd(B, nh, hd, ds)

    pad = (-S) % chunk
    padded = [F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)).movedim(1, 2).contiguous()
              for t in (x, dt, Bm, Cm)]
    args = (padded[0], padded[1], A, padded[2], padded[3], init)
    if ragged:
        run = lambda: ops.ssd(x, dt, A, Bm, Cm, chunk, init)  # noqa: E731
        got = run()
        got = (got[0].movedim(1, 2), got[1])
    else:
        run = lambda: SK.ssd_scan_fwd(*args, chunk=chunk)  # noqa: E731
        got = run()
    want = SK.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    y, y0 = got[0].float(), want[0][:, :, :S].float()
    y_err = float((y - y0).abs().max())
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    y_units = float(((y - y0).abs() / (rtol * y0.abs() + 1e-5 * y0.abs().max())).max())
    s_err = float((got[1] - want[1]).abs().max())
    s_units = s_err / (1e-5 * float(want[1].abs().max()))
    tc = SK.tensor_core_route(dtype, hd, ds, chunk)
    r = {"B": B, "nh": nh, "hd": hd, "G": G, "ds": ds, "chunk": chunk,
         "S": S, "padded_S": S + pad, "path": "ops.ssd" if ragged else "ssd_scan_fwd",
         "dtype": str(dtype).replace("torch.", ""),
         "kernel": "tensor cores (wgmma)" if tc else "CUDA cores",
         "max_abs_err_y": y_err, "y_err_in_tolerance_units": y_units,
         "max_abs_err_state": s_err, "state_err_in_tolerance_units": s_units,
         "max_abs_y": float(y0.abs().max()), "max_abs_state": float(want[1].abs().max())}
    assert y_units <= 1.0 and s_units <= 1.0, r
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(got[1]).all()), r
    if not ragged:
        nbytes, flops = ssd_bound(B, S, nh, hd, G, ds, chunk, itemsize=x.element_size())
        peak = BF16_TC_OPS_PER_S if tc else FP32_OPS_PER_S
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        kernel_ms = time_ms(run, reps=20, warmup=3)
        r.update(kernel_ms=kernel_ms, **device_and_host(run),
                 plain_ms=time_ms(lambda: SK.ssd_scan_plain(*args, chunk=chunk), reps=3),
                 bytes=nbytes, flops=flops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 bound_units=("bf16 tensor cores, 989 TFLOP/s" if tc
                              else "f32 CUDA cores, 67 TFLOP/s"),
                 f32_cuda_core_ms=flops / FP32_OPS_PER_S * 1e3,
                 kernel_TFLOPs=flops / (kernel_ms * 1e-3) / 1e12, library_ms=None)
    emit("ssd_scan", **r)
    return r


def phase_ssd_scan() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    full = ssd_case(SSD_SHAPE["S"], gen)
    ssd_case(SSD_RAGGED_S, gen, ragged=True)
    full["f32"] = ssd_case(SSD_SHAPE["S"], gen, dtype=torch.float32)
    # jamba-v0.1-52b's SSM layer (ds 16): bf16 on the CUDA-core kernel
    jamba = jamba_ssd_shape()
    full["jamba"] = ssd_case(jamba["S"], gen, shape=jamba)
    ssd_case(SSD_RAGGED_S, gen, ragged=True, shape=jamba)
    assert full["jamba"]["kernel"] == "CUDA cores", full["jamba"]
    torch.cuda.empty_cache()
    return full


def jamba_ssd_shape() -> dict:
    """The SSD scan of one jamba-v0.1-52b SSM layer in the serve_families
    prefill: B and S of that prefill, the config's heads, head dim, groups,
    state and chunk."""
    from repro_torch.configs import get_config

    cfg = get_config("jamba-v0.1-52b")
    return dict(B=FAMILY_BATCH, S=FAMILY_PROMPT, nh=cfg.ssm_n_heads, hd=cfg.ssm_head_dim,
                G=cfg.ssm_n_groups, ds=cfg.ssm_state, chunk=cfg.ssm_chunk)


def ulp_units(got, want) -> float:
    """Error in units of the tolerance |Δ| ≤ rtol·|y| + 1e-5·max|y|, rtol 2⁻⁷
    for bf16 (one bf16 ulp: both sides sum in f32 in other orders, then
    round), 0 for f32."""
    import torch

    y, y0 = got.float(), want.float()
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    bound = rtol * y0.abs() + 1e-5 * y0.abs().max()
    err = (y - y0).abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / bound).max())


def flash_bound(B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset, itemsize: int = 2):
    """(bytes, flops, exponentials) flash attention must move and do: q, k, v
    and o each read or written once in ``itemsize`` bytes; both products at 2
    flops per multiply-add, and one exponential, over the (query, key) pairs
    these masks let through."""
    import torch

    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    seen = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        seen &= kp <= qp
    if window is not None:
        seen &= qp - kp < window
    pairs = B * Hq * int(seen.sum())
    nbytes = itemsize * hd * (2 * B * Hq * Sq + 2 * B * Hkv * Sk)
    return nbytes, 4 * pairs * hd, pairs


def flash_case(case, dtype, gen, clock_hz: float) -> dict:
    """Kernel against plain version on the card. y: |Δ| ≤ 2⁻⁷·|y| +
    1e-5·max|y| for bf16 (one bf16 ulp: both sides sum in f32 in other
    orders, then round), 1e-5·max|y| for f32. Times: the kernel, its plain
    version, and F.scaled_dot_product_attention (non-causal, the same shape;
    k and v repeated to Hq heads first where Hkv < Hq) as a yardstick; the
    kernel's device time and host enqueue time. Bound: bytes over HBM, or
    flops over the peak of the dtype's units (bf16 tensor cores, or f32 on
    the CUDA cores); ``exp_ms``, for information, the exponentials over the
    SMs' ex2 rate at ``clock_hz``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK

    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = rnd(B, Hq, Sq, hd), rnd(B, Hkv, Sk, hd), rnd(B, Hkv, Sk, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = FK.flash_attention_fwd(q, k, v, **kw)
    want = FK.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    units = ulp_units(got, want)
    r = {"B": B, "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "hd": hd, "causal": causal,
         "window": window, "q_offset": q_offset, "dtype": str(dtype).replace("torch.", ""),
         "max_abs_err": float((got.float() - want.float()).abs().max()),
         "err_in_tolerance_units": units, "max_abs_y": float(want.float().abs().max())}
    assert units <= 1.0 and bool(torch.isfinite(got).all()), r
    del got, want
    nbytes, flops, exps = flash_bound(*case, itemsize=q.element_size())
    bf16 = dtype == torch.bfloat16
    peak = BF16_TC_OPS_PER_S if bf16 else FP32_OPS_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    kr, vr = (k, v) if Hkv == Hq else (k.repeat_interleave(Hq // Hkv, 1),
                                       v.repeat_interleave(Hq // Hkv, 1))
    call = lambda: FK.flash_attention_fwd(q, k, v, **kw)  # noqa: E731
    kernel_ms = time_ms(call, reps=20, warmup=3)
    r.update(kernel_ms=kernel_ms,
             plain_ms=time_ms(lambda: FK.flash_attention_plain(q, k, v, **kw), reps=3),
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr),
                                reps=20, warmup=3),
             **device_and_host(call),
             bytes=nbytes, flops=flops, bytes_ms=bytes_ms, ops_ms=ops_ms,
             bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bound_units=("bf16 tensor cores, 989 TFLOP/s" if bf16
                          else "f32 CUDA cores, 67 TFLOP/s"),
             exponentials=exps,
             exp_ms=exps / (EXP_PER_SM_PER_CLOCK * N_SMS * clock_hz) * 1e3,
             sm_clock_max_MHz=clock_hz / 1e6,
             bf16_tensor_core_ms=flops / BF16_TC_OPS_PER_S * 1e3,
             kernel_TFLOPs=flops / (kernel_ms * 1e-3) / 1e12)
    emit("flash_attention", **r)
    return r


def flash_ops_case(gen) -> dict:
    """``ops.flash_attention`` at the encoder shape on model-layout (B, S, H,
    hd) bf16 tensors, as whisper's encoder calls it: under torch.profiler the
    call runs exactly one device kernel (no copy of q, k or v, no transposed
    output), o comes back contiguous and within the tolerance of the plain
    version."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK, ops

    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = FLASH_ENCODER
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()  # noqa: E731
    q, k, v = rnd(B, Sq, Hq, hd), rnd(B, Sk, Hkv, hd), rnd(B, Sk, Hkv, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    call = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
    call()
    prof = profile_device(call)
    got = call()
    want = FK.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    **kw).transpose(1, 2)
    torch.cuda.synchronize()
    r = {"case": "ops.flash_attention, model layout", "B": B, "S": Sq, "H": Hq, "hd": hd,
         "device_kernels": prof["device_events"], "device_kernels_ms": prof["top_kernels_ms"],
         "device_ms": prof["device_ms"], "out_contiguous": got.is_contiguous(),
         "err_in_tolerance_units": ulp_units(got, want),
         "kernel_ms": time_ms(call, reps=20, warmup=3)}
    emit("flash_attention", **r)
    assert r["device_kernels"] == 1 and r["out_contiguous"], r
    assert r["err_in_tolerance_units"] <= 1.0, r
    return r


def phase_flash_attention() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    clock_hz = sm_clock_hz()
    encoder = flash_case(FLASH_ENCODER, torch.bfloat16, gen, clock_hz)
    for case in [FLASH_ENCODER] + FLASH_SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            if (case, dtype) != (FLASH_ENCODER, torch.bfloat16):
                flash_case(case, dtype, gen, clock_hz)
    encoder["ops"] = flash_ops_case(gen)
    torch.cuda.empty_cache()
    return encoder


#: the causal ALiBi training pair: (B, S, H, hd) of photon-1.3b's micro-batch
#: in the s2048 and s512 cells
FLASH_ALIBI_CASES = [(1, 2048, 16, 128), (4, 512, 16, 128)]


def _alibi_bias(S, slopes, dtype):
    """ALiBi and the causal mask as one float mask (1, H, S, S) for
    ``F.scaled_dot_product_attention``: −slope·(i − j) where j ≤ i, −inf
    above the diagonal."""
    import torch

    pos = torch.arange(S, device=slopes.device)
    dist = (pos[:, None] - pos[None, :]).float()
    bias = -slopes[:, None, None] * dist
    return bias.masked_fill(dist < 0, float("-inf"))[None].to(dtype)


def phase_flash_alibi() -> dict:
    """The causal ALiBi training kernels at photon-1.3b's layer, through
    ``ops.flash_attention_alibi`` on model-layout tensors: one forward and two
    backward launches a call, the same bits twice. Forward: o and lse within
    the held tolerance of the plain version on the same inputs in float32
    (``flash_attention_alibi_plain``), o + o_lo within 2⁻¹⁴·|o|. Backward: the
    kernels' dq, dk and dv against the plain backward in float32 on the same
    inputs and the kernel's o, o_lo and lse (``flash_attention_alibi_bwd_plain``),
    each within 1.25 times the error that the plain bf16 core
    (``sdpa_chunked``) shows against that oracle, plus 1e-5 of its largest
    value. Times (CUDA events, back to back, which reads the host where it
    enqueues slower than the card runs): each kernel wrapper, the plain core's
    forward and backward alone, and ``F.scaled_dot_product_attention`` with
    the ALiBi bias as a float mask (the same function in one library call)
    forward and backward alone; each wrapper's device time under
    ``torch.profiler`` beside its host enqueue time (``device_and_host``).
    Bound: operations on the bf16 tensor cores, 2 products forward and 5
    backward of 2·hd flops per seen (query, key) pair and head."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK, ops
    from repro_torch.models.attention import sdpa_chunked
    from repro_torch.models.common import alibi_slopes_on

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for B, S, H, hd in FLASH_ALIBI_CASES:
        q, k, v, do = (torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        slopes = alibi_slopes_on(H, torch.device("cuda", torch.cuda.current_device()))
        xs = (q, k, v)
        for x in xs:
            x.requires_grad_(True)
        torch.cuda.synchronize()
        zero_launches()
        y = ops.flash_attention_alibi(q, k, v, slopes)
        y.backward(do)
        torch.cuda.synchronize()
        launches = read_launches()
        assert launches == {n: {"flash_attention_alibi_fwd": 1,
                                "flash_attention_alibi_bwd": 2}.get(n, 0) for n in launches}
        t = lambda x: x.detach().transpose(1, 2)  # noqa: E731
        qf, kf, vf, dof = (t(x).float() for x in (q, k, v, do))
        o, o_lo, lse = FK.flash_attention_alibi_fwd(t(q), t(k), t(v), slopes)
        o0, _, lse0 = FK.flash_attention_alibi_plain(qf, kf, vf, slopes)
        hi_lo = (o.float() + o_lo.float() - o0).abs() / (2.0 ** -14 * o0.abs()
                                                         + 1e-5 * o0.abs().max())
        fwd_units = {"o": ulp_units(o, o0), "lse": ulp_units(lse[..., :S], lse0[..., :S]),
                     "o_plus_o_lo": float(hi_lo.max())}
        del lse0, hi_lo

        def bwd():
            return FK.flash_attention_alibi_bwd(t(q), t(k), t(v), o, o_lo, lse, t(do), slopes)

        grads = bwd()
        want = FK.flash_attention_alibi_bwd_plain(qf, kf, vf, o, o_lo, lse, dof, slopes)
        pos = torch.arange(S, device="cuda")

        def plain():
            return sdpa_chunked(q, k, v, q_pos=pos, k_pos=pos, causal=True, window=None,
                                k_len=None, slopes=slopes)

        y_plain = plain()
        chunked = torch.autograd.grad(y_plain, xs, do, retain_graph=True)
        bwd_err = {}
        for name, g, gc_, g0 in zip("qkv", grads, chunked, want):
            err = float((g.float() - g0).abs().max())
            err_plain = float((t(gc_).float() - g0).abs().max())
            limit = 1.25 * err_plain + 1e-5 * float(g0.abs().max())
            bwd_err[f"d{name}"] = {"max_abs_err": err, "plain_core_max_abs_err": err_plain,
                                   "limit": limit, "finite": bool(torch.isfinite(g).all())}
        again = FK.flash_attention_alibi_fwd(t(q), t(k), t(v), slopes)
        same = (torch.equal(t(y), o) and all(torch.equal(a, b) for a, b in zip((o, o_lo, lse),
                                                                            again))
                and all(torch.equal(a, b) for a, b in zip(grads, bwd())))
        del qf, kf, vf, dof, want, grads, chunked, again
        pairs = B * H * S * (S + 1) // 2
        fwd_flops, bwd_flops = 4 * pairs * hd, 10 * pairs * hd

        def plain_bwd():
            torch.autograd.grad(y_plain, xs, do, retain_graph=True)

        def fwd():
            return FK.flash_attention_alibi_fwd(t(q), t(k), t(v), slopes)

        with torch.no_grad():
            fwd_ms = time_ms(fwd, reps=50, warmup=3)
            fwd_dh = device_and_host(fwd)
            plain_fwd_ms = time_ms(plain, reps=10)
        bwd_ms = time_ms(bwd, reps=50, warmup=3)
        bwd_dh = device_and_host(bwd)
        plain_bwd_ms = time_ms(plain_bwd, reps=10)
        del y_plain
        qh, kh, vh = (t(x).contiguous().requires_grad_(True) for x in xs)
        bias = _alibi_bias(S, slopes, q.dtype)

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

        try:
            with torch.no_grad():
                library_fwd_ms = time_ms(library, reps=20, warmup=3)
            y_lib = library()
            library_units = ulp_units(y_lib.detach(), o0)
            library_bwd_ms = time_ms(
                lambda: torch.autograd.grad(y_lib, (qh, kh, vh), t(do), retain_graph=True),
                reps=20, warmup=3)
            library_note = None
            del y_lib
        except RuntimeError as e:  # no SDPA backend for the mask, or out of memory
            library_fwd_ms = library_bwd_ms = library_units = None
            library_note = str(e).splitlines()[0][:200]
        del qh, kh, vh, bias, o0
        r = {"B": B, "S": S, "H": H, "hd": hd, "launches": launches,
             "fwd_err_in_tolerance_units": fwd_units, "bwd_err": bwd_err,
             "same_bits_twice": same,
             "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
             "fwd_device_ms": fwd_dh["device_ms"], "fwd_host_ms": fwd_dh["host_enqueue_ms"],
             "bwd_device_ms": bwd_dh["device_ms"], "bwd_host_ms": bwd_dh["host_enqueue_ms"],
             "bwd_device_kernels_ms": bwd_dh["device_kernels_ms"],
             "fwd_bound_ms": fwd_flops / BF16_TC_OPS_PER_S * 1e3,
             "bwd_bound_ms": bwd_flops / BF16_TC_OPS_PER_S * 1e3,
             "fwd_bwd_ms": time_ms(lambda: ops.flash_attention_alibi(q, k, v, slopes).backward(do),
                                   reps=20, warmup=3),
             "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
             "library_fwd_ms": library_fwd_ms, "library_bwd_ms": library_bwd_ms,
             "library_note": library_note, "library_err_in_tolerance_units": library_units,
             "fwd_TFLOPs": fwd_flops / (fwd_dh["device_ms"] * 1e-3) / 1e12,
             "bwd_TFLOPs": bwd_flops / (bwd_dh["device_ms"] * 1e-3) / 1e12}
        emit("flash_alibi", **r)
        assert max(fwd_units.values()) <= 1.0 and same, r
        assert all(e["finite"] and e["max_abs_err"] <= e["limit"] for e in bwd_err.values()), r
        out[(B, S, H, hd)] = r
        del q, k, v, do, y, o, o_lo, lse
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Flash decode and RMSNorm, through their entry points
# ---------------------------------------------------------------------------


def entry_call(name: str, fn):
    """One call of an entry point as a user makes it, the launch counts zeroed
    just before and read just after: exactly one launch of ``name``. Returns
    the output and that count."""
    import torch

    torch.cuda.synchronize()
    zero_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches == {n: int(n == name) for n in launches}, (name, launches)
    return out, launches[name]


def decode_bound(B, Hq, Hkv, S, hd, kv_len, window, itemsize: int = 2):
    """(bytes, flops) decode attention must move and do: q and o once, kv_len,
    and the key and value rows each batch row sees, once per kv head; both
    products at 2 flops per multiply-add for every query head."""
    seen = 0
    for n in kv_len:
        lo = 0 if window is None else max(0, n - window)
        seen += max(0, min(n, S) - lo)
    nbytes = itemsize * (2 * B * Hq * hd + 2 * seen * Hkv * hd) + 4 * B
    return nbytes, 4 * seen * Hq * hd


def _bound_fields(nbytes: int, flops: int, kernel_ms: float) -> dict:
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "kernel_GBps": nbytes / (kernel_ms * 1e-3) / 1e9}


def randn_cuda(shape, gen):
    import torch

    return torch.randn(shape, generator=gen, device="cuda")


def device_and_host(call) -> dict:
    """The device time of one call (its kernels under ``torch.profiler``) and
    the host's time to enqueue one, without waiting for the card (the mean
    of 20 calls): where the second is the larger, back-to-back calls
    (``kernel_ms``) wait on the host."""
    import torch

    prof = profile_device(call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        call()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    return {"device_ms": prof["device_ms"], "device_kernels_ms": prof["top_kernels_ms"],
            "host_enqueue_ms": host_ms}


def _fill_randn(t, gen, rows: int) -> None:
    """Fill a bf16 tensor with randn in slices of ``rows`` along dim 0 (the
    f32 draw of the whole would need twice its size again)."""
    for i in range(0, t.shape[0], rows):
        t[i:i + rows] = randn_cuda(t[i:i + rows].shape, gen)


def decode_case(case, gen) -> dict:
    """One full-size decode layer: the entry point once (counted), its output
    against the plain version, then kernel, plain and SDPA times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import kernel as DK, ops

    name, B, Hq, Hkv, S, hd, window = case
    q = randn_cuda((B, 1, Hq, hd), gen).bfloat16()
    kc = torch.empty((B, S, Hkv, hd), dtype=torch.bfloat16, device="cuda")  # model layout
    vc = torch.empty_like(kc)
    _fill_randn(kc, gen, max(1, B // 16))
    _fill_randn(vc, gen, max(1, B // 16))
    kv_len = torch.full((B,), S, dtype=torch.int32, device="cuda")
    out, launches = entry_call("flash_decode",
                               lambda: ops.flash_decode(q, kc, vc, kv_len, window=window))
    k, v = kc.movedim(1, 2), vc.movedim(1, 2)  # (B, Hkv, S, hd) views of the caches
    n = min(B, DECODE_PLAIN_ROWS)
    want = DK.flash_decode_plain(q[:n, 0], k[:n], v[:n], kv_len[:n], window=window)
    torch.cuda.synchronize()
    units = ulp_units(out[:n, 0], want)
    err = float((out[:n, 0].float() - want.float()).abs().max())
    r = {"case": name, "B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "hd": hd, "window": window,
         "kv_len": S, "dtype": "bfloat16", "launches": launches, "compared_rows": n,
         "max_abs_err": err,
         "err_in_tolerance_units": units, "max_abs_y": float(want.float().abs().max()),
         "n_split": DK.n_splits(B, Hq, Hkv, S, window, DK.sm_count(0))}
    assert units <= 1.0 and bool(torch.isfinite(out).all()), r
    del out, want

    if window is None:
        lens = [kv_len]
    else:  # 16 windows in turn (67 MB together): no launch finds its keys in the 50 MB L2
        lens = [torch.full((B,), S - i * window, dtype=torch.int32, device="cuda")
                for i in range(16)]
    turn = iter(range(1 << 30))
    call = lambda: DK.flash_decode_fwd(q[:, 0], k, v, lens[next(turn) % len(lens)],  # noqa: E731
                                       window=window)
    kernel_ms = time_ms(call, reps=16, warmup=2)

    def plain_all_rows():  # the plain version over every row, DECODE_PLAIN_ROWS at a time
        for i in range(0, B, n):
            DK.flash_decode_plain(q[i:i + n, 0], k[i:i + n], v[i:i + n], kv_len[i:i + n],
                                  window=window)

    plain_ms = time_ms(plain_all_rows, reps=2, warmup=1)
    pos = torch.arange(S, device="cuda")[None]
    mask = pos < kv_len[:, None]
    if window is not None:
        mask &= pos > (kv_len - 1 - window)[:, None]
    qh = q.transpose(1, 2)  # (B, Hq, 1, hd)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, k, v, attn_mask=mask[:, None, None], enable_gqa=True)
    try:
        library_ms = time_ms(sdpa, reps=5, warmup=1)
        library_kernels = list(profile_device(sdpa)["top_kernels_ms"])[:3]
    except torch.cuda.OutOfMemoryError:
        library_ms, library_kernels = None, ["out of device memory"]
    nbytes, flops = decode_bound(B, Hq, Hkv, S, hd, [S] * B, window)
    # the entry point as a model calls it, with one int kv_len for every row:
    # it reaches the kernel as an argument (no device tensor per call)
    scalar = device_and_host(lambda: ops.flash_decode(q, kc, vc, S, window=window))
    r.update(kernel_ms=kernel_ms, **device_and_host(call), plain_ms=plain_ms,
             ops_scalar_kv_len_device_ms=scalar["device_ms"],
             ops_scalar_kv_len_host_enqueue_ms=scalar["host_enqueue_ms"],
             library_ms=library_ms, library_kernels=library_kernels,
             **_bound_fields(nbytes, flops, kernel_ms))
    emit("flash_decode", **r)
    del q, kc, vc, k, v, mask, lens
    gc.collect()
    torch.cuda.empty_cache()
    return r


def phase_flash_decode() -> dict:
    import torch
    from repro_torch.kernels.flash_decode import kernel as DK

    gen = torch.Generator(device="cuda").manual_seed(5)
    full = {case[0]: decode_case(case, gen) for case in decode_cases()}
    for B, Hq, Hkv, S, hd, kv_len, window in DECODE_SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn_cuda((B, Hq, hd), gen).to(dtype)
            k, v = (randn_cuda((B, Hkv, S, hd), gen).to(dtype) for _ in range(2))
            kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            got = DK.flash_decode_fwd(q, k, v, kl, window=window)
            want = DK.flash_decode_plain(q, k, v, kl, window=window)
            torch.cuda.synchronize()
            units = ulp_units(got, want)
            r = {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "hd": hd, "kv_len": list(kv_len),
                 "window": window, "dtype": str(dtype).replace("torch.", ""),
                 "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "err_in_tolerance_units": units}
            emit("flash_decode", **r)
            seen = torch.tensor([n > 0 and window != 0 for n in kv_len], device="cuda")
            assert units <= 1.0 and bool((got[~seen] == 0).all()), r
    return full


def rms_units(got, want) -> float:
    """Error in units of the tolerance: bf16 |Δ| ≤ one bf16 ulp of y; f32
    |Δ| ≤ 2e-6·|y| (the sum of squares taken in another order)."""
    import torch

    y, y0 = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        bound = torch.ldexp(torch.ones_like(y0), torch.frexp(y0.abs())[1] - 8)
    else:
        bound = 2e-6 * y0.abs()
    err = (y - y0).abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / bound).max())


def rms_case(name: str, R: int, D: int, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as RK, ops

    x = torch.empty((R, D), dtype=torch.bfloat16, device="cuda")
    _fill_randn(x, gen, 65536)
    scale = 1.0 + 0.1 * randn_cuda((D,), gen)
    y, launches = entry_call("rmsnorm", lambda: ops.rmsnorm(x, scale))
    want = RK.rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    units = rms_units(y, want)
    r = {"case": name, "R": R, "D": D, "dtype": "bfloat16", "launches": launches,
         "max_abs_err": float((y.float() - want.float()).abs().max()),
         "err_in_tolerance_units": units}
    assert units <= 1.0 and bool(torch.isfinite(y).all()), r
    del y, want
    call = lambda: RK.rmsnorm_fwd(x, scale)  # noqa: E731
    kernel_ms = time_ms(call, reps=10, warmup=2)
    plain_ms = time_ms(lambda: RK.rmsnorm_plain(x, scale), reps=3, warmup=1)
    scale_x = scale.to(x.dtype)  # F.rms_norm takes its weight in x's dtype
    library_ms = time_ms(lambda: F.rms_norm(x, (D,), scale_x, 1e-6), reps=10, warmup=2)
    nbytes, flops = 2 * R * D * x.element_size() + 4 * D, 4 * R * D
    r.update(kernel_ms=kernel_ms, **device_and_host(call), plain_ms=plain_ms,
             library_ms=library_ms, **_bound_fields(nbytes, flops, kernel_ms))
    emit("rmsnorm", **r)
    del x
    torch.cuda.empty_cache()
    return r


def phase_rmsnorm() -> dict:
    import torch
    from repro_torch.kernels.rmsnorm import kernel as RK

    gen = torch.Generator(device="cuda").manual_seed(6)
    full = {name: rms_case(name, R, D, gen) for name, R, D in rms_cases()}
    for R, D in RMS_SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            x = randn_cuda((R, D), gen).to(dtype)
            scale = 1.0 + 0.1 * randn_cuda((D,), gen)
            got, want = RK.rmsnorm_fwd(x, scale), RK.rmsnorm_plain(x, scale)
            torch.cuda.synchronize()
            r = {"R": R, "D": D, "dtype": str(dtype).replace("torch.", ""),
                 "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "err_in_tolerance_units": rms_units(got, want)}
            emit("rmsnorm", **r)
            assert r["err_in_tolerance_units"] <= 1.0, r
    return full


def phase_serve_check() -> None:
    """Reduced mamba2-1.3b, photon-75m, whisper-large-v3, gemma3-4b,
    deepseek-moe-16b and jamba-v0.1-52b serve the same greedy tokens on the
    card (the SSD and flash kernels under use_pallas) and on the CPU (their
    plain versions), float32 compute, the same seed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    for arch in ("mamba2-1.3b", "photon-75m", "whisper-large-v3", "gemma3-4b",
                 "deepseek-moe-16b", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
        model = build_model(cfg)
        gen = torch.Generator().manual_seed(3)
        prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, dtype=torch.int32)
        audio = torch.randn((2, cfg.n_audio_frames, cfg.d_model), generator=gen) \
            if cfg.enc_dec else None
        out = {dev: generate(model, model.init(0, device=dev), prompt.to(dev), 8,
                             audio_embed=None if audio is None else audio.to(dev),
                             use_pallas=True).cpu() for dev in ("cpu", "cuda")}
        same = bool(torch.equal(out["cpu"], out["cuda"]))
        emit("check", serve=arch, tokens_cuda=out["cuda"][:, 40:].tolist(),
             tokens_cpu=out["cpu"][:, 40:].tolist(), same=same)
        assert same, arch


def rel_err(got, want) -> float:
    """max|got - want| / max|want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


def profile_device(fn) -> dict:
    """Device time of one call of ``fn`` under ``torch.profiler``, by kernel
    name (the eight longest), with the call's wall time under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}  # kernel names cut to 90 characters; kernels that share those add up
    counts = {}
    events = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            events += 1
            by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
            counts[e.name[:90]] = counts.get(e.name[:90], 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": sum(by_name.values()), "profiled_wall_ms": wall_ms,
            "top_kernels_ms": dict(top), "device_events": events,
            # the port's own kernels (each in an anonymous namespace of csrc/), by name
            "port_kernel_counts": {n: c for n, c in counts.items()
                                   if "(anonymous namespace)" in n}}


def _serve(model, params, prompt, use_pallas: bool, audio=None) -> dict:
    """``generate`` as a user calls it (the launch counts zeroed just before,
    read just after), then its two parts timed apart: one prefill, and the
    decode steps from that prefill's cache."""
    import torch
    from repro_torch.launch.serve import generate, merge

    B, S0 = prompt.shape
    batch = {"tokens": prompt} if audio is None else {"tokens": prompt, "audio_embed": audio}
    gc.collect()  # reference cycles of earlier phases may still hold device memory
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 1e9  # the weights and the inputs
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, SERVE_GEN, audio_embed=audio, use_pallas=use_pallas)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, use_pallas=use_pallas)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = read_launches()
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    prefill_end = torch.cuda.memory_allocated() / 1e9  # + the prefill's cache and logits
    cache = merge(model.init_cache(B, S0 + SERVE_GEN, device=prompt.device), cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9  # weights and the grown cache
    t0 = time.perf_counter()
    for i in range(SERVE_GEN - 1):
        logits, cache = model.decode_step(params, cache, tok, S0 + i, use_pallas=use_pallas)
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = read_launches()
    decode_peak = torch.cuda.max_memory_allocated() / 1e9
    assert tuple(out.shape) == (B, S0 + SERVE_GEN), out.shape
    assert bool(((out >= 0) & (out < model.cfg.vocab_size)).all())
    assert bool(torch.isfinite(logits).all())

    # where the time goes: device time per kernel, and the device's busy share
    # of the unprofiled wall time (prefill; one decode step)
    prof_prefill = profile_device(lambda: model.prefill(params, batch, use_pallas=use_pallas))
    prof_decode = profile_device(
        lambda: model.decode_step(params, cache, tok, S0 + SERVE_GEN - 1, use_pallas=use_pallas))
    step_ms = decode_s / (SERVE_GEN - 1) * 1e3
    return {"generate_s": generate_s, "prefill_s": prefill_s, "decode_s": decode_s,
            "prefill_tokens_per_s": B * S0 / prefill_s,
            "decode_tokens_per_s": B * (SERVE_GEN - 1) / decode_s, "decode_step_ms": step_ms,
            "resident_mem_GB": resident, "peak_mem_GB": peak, "prefill_peak_mem_GB": prefill_peak,
            "prefill_end_mem_GB": prefill_end,
            "decode_start_mem_GB": held, "decode_peak_mem_GB": decode_peak,
            "launches": launches, "prefill_launches": prefill_launches,
            "decode_launches": decode_launches, "tokens": out[:, S0:].tolist(),
            "prefill_device_busy_share": prof_prefill["device_ms"] / (prefill_s * 1e3),
            "decode_device_busy_share": prof_decode["device_ms"] / step_ms,
            "prefill_profile": prof_prefill, "decode_step_profile": prof_decode}


def phase_serve_mamba2() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config("mamba2-1.3b")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert cfg.n_layers == MAMBA2_LAYERS and cfg.d_model == 2048
    t0 = time.perf_counter()
    params = build_model(cfg).init(0, device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SSD_SHAPE["S"]), generator=gen,
                           dtype=torch.int32).cuda()
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=n_params, param_count=cfg.param_count(), init_s=init_s)

    # use_pallas against the plain path on the card, float32 then bf16 compute
    for c in (cfg32, cfg):
        model = build_model(c)
        lk, ck = model.prefill(params, {"tokens": prompt}, use_pallas=True)
        lp, cp = model.prefill(params, {"tokens": prompt}, use_pallas=False)
        torch.cuda.synchronize()
        scale = float(lp.float().abs().max())
        logit_err = float((lk.float() - lp.float()).abs().max())
        cache_err = {name: rel_err(ck[0]["pos0"]["mixer"][name], cp[0]["pos0"]["mixer"][name])
                     for name in ("conv", "ssd")}
        same_tokens = bool(torch.equal(torch.argmax(lk[:, -1], -1), torch.argmax(lp[:, -1], -1)))
        r = {"compute_dtype": c.compute_dtype, "logits_max_abs_err": logit_err,
             "logits_max_abs": scale, "logits_rel_err": logit_err / scale,
             "cache_rel_err": cache_err, "same_greedy_tokens": same_tokens}
        emit("serve", arch=cfg.name, check="prefill use_pallas vs plain", **r)
        assert all(math.isfinite(v) for v in (logit_err, *cache_err.values())), r
        if c.compute_dtype == "float32":
            # 48 layers of f32 sums that the kernel and the einsum chain may
            # take in other orders (on the H100 with cuBLAS's f32 GEMMs both
            # run one FMA chain per output in k order, and they agree bitwise)
            assert logit_err <= 1e-4 * scale, r
            assert max(cache_err.values()) <= 1e-4, r
        del lk, ck, lp, cp
        torch.cuda.empty_cache()

    model = build_model(cfg)
    r = _serve(model, params, prompt, use_pallas=True)
    emit("serve", arch=cfg.name, batch=SERVE_BATCH, prompt=SSD_SHAPE["S"], new_tokens=SERVE_GEN,
         use_pallas=True, **r)
    others = {n: 0 for n in r["launches"] if n != "ssd_scan"}
    assert r["launches"] == {"ssd_scan": MAMBA2_LAYERS, **others}, r["launches"]
    assert r["prefill_launches"] == {"ssd_scan": MAMBA2_LAYERS, **others}, r
    assert r["decode_launches"] == {"ssd_scan": 0, **others}, r
    # the bf16 prefill runs the tensor-core kernel, once per layer
    counts = r["prefill_profile"]["port_kernel_counts"]
    tc = sum(n for name, n in counts.items() if "ssd_scan_tc_kernel<" in name)
    emit("serve", arch=cfg.name, prefill_ssd_scan_tc_kernel_runs=tc)
    assert tc == MAMBA2_LAYERS, counts
    del params
    torch.cuda.empty_cache()
    return r


def phase_serve_photon() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("photon-75m")
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PHOTON_PROMPT), generator=gen,
                           dtype=torch.int32).cuda()
    r = _serve(model, params, prompt, use_pallas=False)
    emit("serve", arch=cfg.name, batch=SERVE_BATCH, prompt=PHOTON_PROMPT, new_tokens=SERVE_GEN,
         use_pallas=False, **r)
    for launches in (r["launches"], r["prefill_launches"], r["decode_launches"]):
        assert all(v == 0 for v in launches.values()), launches
    del params
    torch.cuda.empty_cache()
    return r


def phase_serve_whisper() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config("whisper-large-v3")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert cfg.n_encoder_layers == WHISPER_LAYERS and cfg.d_model == 1280
    t0 = time.perf_counter()
    params = build_model(cfg).init(0, device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, WHISPER_PROMPT), generator=gen,
                           dtype=torch.int32).cuda()
    audio = torch.randn((SERVE_BATCH, cfg.n_audio_frames, cfg.d_model), generator=gen).cuda()
    batch = {"tokens": prompt, "audio_embed": audio}
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, n_encoder_layers=cfg.n_encoder_layers,
         d_model=cfg.d_model, n_params=n_params, param_count=cfg.param_count(), init_s=init_s)
    assert n_params == 1_578_803_200, n_params

    # use_pallas against the plain path on the card, float32 then bf16 compute
    for c in (cfg32, cfg):
        model = build_model(c)
        lk, ck = model.prefill(params, batch, use_pallas=True)
        lp, cp = model.prefill(params, batch, use_pallas=False)
        torch.cuda.synchronize()
        scale = float(lp.float().abs().max())
        logit_err = float((lk.float() - lp.float()).abs().max())
        cache_err = {name: rel_err(ck[0]["pos0"][name]["k"], cp[0]["pos0"][name]["k"])
                     for name in ("mixer", "cross")}
        same = int((torch.argmax(lk[:, -1], -1) == torch.argmax(lp[:, -1], -1)).sum())
        r = {"compute_dtype": c.compute_dtype, "logits_max_abs_err": logit_err,
             "logits_max_abs": scale, "logits_rel_err": logit_err / scale,
             "cache_rel_err": cache_err, "same_next_tokens": same, "of": SERVE_BATCH}
        emit("serve", arch=cfg.name, check="prefill use_pallas vs plain", **r)
        assert all(math.isfinite(v) for v in (logit_err, *cache_err.values())), r
        if c.compute_dtype == "float32":
            # 32 encoder layers whose attention the kernel sums in another order
            # than the einsums, then 32 decoder layers on that output
            assert logit_err <= 1e-4 * scale, r
            assert max(cache_err.values()) <= 1e-4, r
        del lk, ck, lp, cp
        torch.cuda.empty_cache()

    model = build_model(cfg)
    plain = generate(model, params, prompt, SERVE_GEN, audio_embed=audio).cpu()
    r = _serve(model, params, prompt, use_pallas=True, audio=audio)
    agree = int((torch.tensor(r["tokens"]) == plain[:, WHISPER_PROMPT:]).sum())
    emit("serve", arch=cfg.name, batch=SERVE_BATCH, prompt=WHISPER_PROMPT,
         audio_frames=cfg.n_audio_frames, new_tokens=SERVE_GEN, use_pallas=True,
         bf16_tokens_agreeing_with_plain_path=agree, of=SERVE_BATCH * SERVE_GEN, **r)
    others = {n: 0 for n in r["launches"] if n != "flash_attention"}
    assert r["launches"] == {"flash_attention": WHISPER_LAYERS, **others}, r["launches"]
    assert r["prefill_launches"] == {"flash_attention": WHISPER_LAYERS, **others}, r
    assert r["decode_launches"] == {"flash_attention": 0, **others}, r
    del params
    torch.cuda.empty_cache()
    return r


def family_config(arch: str, layers):
    """The arch's config at published widths, depth cut to ``layers``."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def _jamba_pallas_check(cfg, params, prompt) -> dict:
    """Jamba's prefill with ``use_pallas`` against the plain path on the card,
    f32 then bf16 compute: logits, the caches of its first SSM layer (before
    any MoE layer, so only the kernel moves them) and the greedy token. f32
    holds the layer's caches to 1e-4; the logits pass through three MoE
    layers whose routing a last-bit difference may change, so they are
    reported."""
    import torch
    from repro_torch.models import build_model

    out = {}
    for c in (dataclasses.replace(cfg, compute_dtype="float32"), cfg):
        model = build_model(c)
        lk, ck = model.prefill(params, {"tokens": prompt}, use_pallas=True)
        lp, cp = model.prefill(params, {"tokens": prompt}, use_pallas=False)
        torch.cuda.synchronize()
        scale = float(lp.float().abs().max())
        logit_err = float((lk.float() - lp.float()).abs().max())
        cache_err = {name: rel_err(ck[0]["pos0"]["mixer"][name], cp[0]["pos0"]["mixer"][name])
                     for name in ("conv", "ssd")}
        r = {"compute_dtype": c.compute_dtype, "logits_max_abs_err": logit_err,
             "logits_max_abs": scale, "logits_rel_err": logit_err / scale,
             "first_ssm_layer_cache_rel_err": cache_err,
             "same_greedy_tokens": bool(torch.equal(torch.argmax(lk[:, -1], -1),
                                                    torch.argmax(lp[:, -1], -1)))}
        emit("serve_families", arch=cfg.name, check="prefill use_pallas vs plain", **r)
        assert all(math.isfinite(v) for v in (logit_err, *cache_err.values())), r
        if c.compute_dtype == "float32":
            assert max(cache_err.values()) <= 1e-4, r
        out[c.compute_dtype] = r
        del lk, ck, lp, cp
        torch.cuda.empty_cache()
    return out


def phase_serve_families() -> dict:
    """Every dense RoPE/GQA decoder and MoE arch at its published widths
    (``FAMILY_DEPTHS``): f32 weights from ``Model.init(0, device="cuda")``,
    bf16 compute, ``generate(use_pallas=True)`` as ``_serve`` runs it. The
    decoders' attention takes ``sdpa`` (a layer's window is a 0-d tensor), so
    no kernel launches; jamba launches ``ssd_scan`` once per SSM layer per
    prefill and never in a decode step."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    out = {}
    for arch, layers in FAMILY_DEPTHS:
        cfg = family_config(arch, layers)
        assert 4 * cfg.param_count() <= FAMILY_WEIGHT_BYTES, (arch, cfg.param_count())
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init(0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in tree_leaves(params))
        gen = torch.Generator().manual_seed(11)
        prompt = torch.randint(0, cfg.vocab_size, (FAMILY_BATCH, FAMILY_PROMPT), generator=gen,
                               dtype=torch.int32).cuda()
        kinds = cfg.layer_kinds()
        head = {"arch": arch, "n_layers": cfg.n_layers,
                "published_layers": family_config(arch, None).n_layers,
                "layer_kinds": "".join("A" if k.mixer == "attn" else "M" for k in kinds),
                "moe_layers": sum(k.ffn == "moe" for k in kinds), "d_model": cfg.d_model,
                "n_params": n_params, "param_count": cfg.param_count(),
                "f32_weights_GB": 4 * n_params / 1e9, "init_s": init_s}
        emit("serve_families", **head)
        check = _jamba_pallas_check(cfg, params, prompt) if cfg.ssm_state else None
        r = _serve(model, params, prompt, use_pallas=True)
        n_ssd = sum(k.mixer == "ssm" for k in kinds)
        summary = {**head, "batch": FAMILY_BATCH, "prompt": FAMILY_PROMPT,
                   "new_tokens": SERVE_GEN, "prefill_ms": r["prefill_s"] * 1e3,
                   "decode_step_ms": r["decode_step_ms"], "peak_mem_GB": r["peak_mem_GB"],
                   "prefill_device_ms": r["prefill_profile"]["device_ms"],
                   "decode_step_device_ms": r["decode_step_profile"]["device_ms"],
                   "prefill_device_busy_share": r["prefill_device_busy_share"],
                   "decode_device_busy_share": r["decode_device_busy_share"],
                   "launches": r["launches"], "prefill_launches": r["prefill_launches"],
                   "decode_launches": r["decode_launches"], "tokens": r["tokens"],
                   "prefill_top_kernels_ms": r["prefill_profile"]["top_kernels_ms"],
                   "decode_top_kernels_ms": r["decode_step_profile"]["top_kernels_ms"]}
        emit("serve_families", **summary)
        others = {n: 0 for n in r["launches"] if n != "ssd_scan"}
        assert r["launches"] == {"ssd_scan": n_ssd, **others}, r["launches"]
        assert r["prefill_launches"] == {"ssd_scan": n_ssd, **others}, r["prefill_launches"]
        assert r["decode_launches"] == {"ssd_scan": 0, **others}, r["decode_launches"]
        if arch.startswith("jamba"):
            assert n_ssd == JAMBA_SSM_LAYERS, kinds
        out[arch] = {**summary, "pallas_check": check}
        del params, model, r
        torch.cuda.empty_cache()
    return out


def phase_train_moe() -> dict:
    """``launch/train.run`` on deepseek-moe-16b at published widths, depth 2
    (layer 0 dense, layer 1 MoE), ``--fused-server`` over 2 clients for 2
    rounds: ``server_apply`` once per round at C = 2 over the flat N, no
    other kernel; loss, val_ppl and (one ``Model.loss`` on the trained
    params) moe_aux finite; ``server_apply`` then held to its plain version
    at that (C, N)."""
    import torch
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    cfg = family_config("deepseek-moe-16b", MOE_TRAIN_LAYERS)
    assert [k.ffn for k in cfg.layer_kinds()] == ["dense", "moe"]
    args = T.parse_args(MOE_TRAIN_ARGS + ["--device", "cuda"])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with _KernelInputs() as widths:
        out = T.run(args, cfg=cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = out["state"]["params"]
    n_params = sum(x.numel() for x in tree_leaves(params))
    Np = -(-n_params // 8192) * 8192  # the flat buffer, padded to 8192-blocks
    tokens_per_round = args.clients * args.local_steps * args.batch * args.seq_len
    for row in out["history"]:
        emit("train_moe", round=row["round"], loss=row["train_loss"], val_ppl=row["val_ppl"],
             pseudo_grad_norm=row["pseudo_grad_norm"], seconds=row["seconds"],
             tokens_per_s=tokens_per_round / row["seconds"])
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.seq_len), generator=gen,
                         dtype=torch.int32).cuda()
    with torch.no_grad():
        loss, metrics = out["model"].loss(params, {"tokens": toks})
    r = {"n_layers": cfg.n_layers, "n_params": n_params, "param_count": cfg.param_count(),
         "f32_weights_GB": 4 * n_params / 1e9, "Np": Np, "clients": args.clients,
         "total_seconds": seconds, "round_seconds": [row["seconds"] for row in out["history"]],
         "peak_mem_GB": peak, "peak_over_weights": peak / (4 * n_params / 1e9),
         "launches": launches, "widths": widths.calls,
         "final_loss": float(loss), "final_moe_aux": float(metrics["moe_aux"])}
    emit("train_moe", **r)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(params)), "non-finite params"
    for row in out["history"]:
        assert math.isfinite(row["train_loss"]) and math.isfinite(row["val_ppl"]), row
    assert math.isfinite(r["final_loss"]) and math.isfinite(r["final_moe_aux"]), r
    want = {name: args.rounds if name == "server_apply" else 0 for name in launches}
    assert launches == want, (launches, want)
    assert widths.calls == [args.clients] * args.rounds, widths.calls
    assert Np * args.clients > 2 ** 31, Np  # C·N past int32: the kernel indexes in int64
    del out, params, loss, metrics
    gc.collect()
    torch.cuda.empty_cache()
    r["held"] = _widths_held(widths.calls, "train_moe",
                             torch.Generator(device="cuda").manual_seed(13), Np=Np)
    return r


def _example(mod, argv):
    """``mod.main(argv)`` on the card, its stdout captured, the kernel counts
    zeroed just before and read just after; ``(result, rows, launches,
    seconds)``."""
    import contextlib
    import io

    import torch

    out = io.StringIO()
    gc.collect()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = mod.main(list(argv) + ["--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, out.getvalue().splitlines(), read_launches(), seconds


def _socket_demos() -> dict:
    """The four ``socket_federation`` demos with ``--fused-server``, each a
    process of its own (with its server and worker processes under it), all
    started together; each must exit 0 with its PASS lines. A demo that
    outlives its timeout is killed with every process of its group."""
    import signal

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="1")
    procs = {demo: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.socket_federation", "--demo", demo,
         "--fused-server"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT, start_new_session=True) for demo in SOCKET_DEMOS}
    t0 = time.perf_counter()
    results = {}
    try:
        for demo, proc in procs.items():
            left = max(1.0, SOCKET_DEMO_TIMEOUT - (time.perf_counter() - t0))
            log, _ = proc.communicate(timeout=left)
            passes = [l for l in log.splitlines() if l.startswith("PASS")]
            results[demo] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                             "pass_lines": passes}
            emit("examples", example="socket_federation", demo=demo, **results[demo])
            assert proc.returncode == 0 and passes, (demo, log[-4000:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
    assert "bitwise-equal" in results["round"]["pass_lines"][0], results["round"]
    assert "bitwise-equal" in results["kill-resume"]["pass_lines"][0], results["kill-resume"]
    return results


def _client_steps_profile(model, params, args) -> dict:
    """One client's ``E2E_PROFILE_STEPS`` local AdamW steps (``run_clients``
    at C = 1) at the run's (B, S) on its trained params, once to warm up,
    then under ``torch.profiler``: wall and device ms a step, busy share."""
    import torch
    from repro_torch.core import FederatedConfig, InnerOptConfig, run_clients

    steps = E2E_PROFILE_STEPS
    fed = FederatedConfig(clients_per_round=1, local_steps=steps,
                          inner=InnerOptConfig(lr_max=args.inner_lr, warmup_steps=1,
                                               total_steps=steps))
    gen = torch.Generator().manual_seed(15)
    toks = torch.randint(0, model.cfg.vocab_size, (steps, 1, args.batch, args.seq_len),
                         generator=gen, dtype=torch.int32).cuda()
    state = {"params": params, "round": 0}

    def client_phase():
        run_clients(model.loss, fed, state, {"tokens": toks})

    client_phase()
    prof = profile_device(client_phase)
    return {"steps": steps, "wall_ms_per_step": prof["profiled_wall_ms"] / steps,
            "device_ms_per_step": prof["device_ms"] / steps,
            "busy_share": prof["device_ms"] / prof["profiled_wall_ms"],
            "top_kernels_ms": prof["top_kernels_ms"]}


def _examples_heterogeneous() -> dict:
    """heterogeneous_federation's sync and async ``--fused-server`` runs: the
    launches against the rounds and the driver's counters, finite params,
    then every fedcore launch of the two runs held to its plain version at
    the shapes (and, for the codecs, on the inputs) that the runs gave it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.aggregator import ASYNC_KERNEL_COUNTERS
    from repro_torch.examples import heterogeneous_federation
    from repro_torch.tree import tree_leaves

    r = {}
    layers = get_config("photon-75m").reduced().n_layers  # the example's model
    inputs = _KernelInputs()
    with inputs:
        agg, rows, launches, seconds = _example(heterogeneous_federation,
                                                EXAMPLE_HETERO["sync"])
    rounds = int(EXAMPLE_HETERO["sync"][EXAMPLE_HETERO["sync"].index("--rounds") + 1])
    emit("examples", example="heterogeneous_federation sync", rows=rows, launches=launches,
         seconds=seconds)
    H = heterogeneous_federation
    rest = without_alibi(launches, layers, rounds * H.CLIENTS * H.TAU,
                         rounds * EXAMPLE_EVAL_BATCHES)
    want = {n: rounds if n in EXAMPLE_SYNC_KERNELS else 0 for n in rest}
    assert rest == want, (launches, want)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(agg.state["params"]))
    r["heterogeneous_sync"] = {"launches": launches, "seconds": seconds}

    with inputs:
        drv, rows, launches, seconds = _example(heterogeneous_federation,
                                                EXAMPLE_HETERO["async"])
    counts = {"n_flushes": drv.n_flushes, "n_client_phases": drv.n_client_phases,
              "n_admissions": drv.n_admissions}
    emit("examples", example="heterogeneous_federation async", rows=rows, launches=launches,
         seconds=seconds, **counts)
    counters = ASYNC_KERNEL_COUNTERS["int8"]
    rest = without_alibi(launches, layers, counts["n_client_phases"] * H.TAU,
                         counts["n_flushes"] * EXAMPLE_EVAL_BATCHES)
    want = {n: counts[counters[n]] if n in counters else 0 for n in rest}
    assert rest == want and counts["n_flushes"] == rounds, (launches, want, counts)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(drv.state["params"]))
    r["heterogeneous_async"] = {"launches": launches, "seconds": seconds, **counts}
    del agg, drv
    assert len(inputs.server_apply) == sum(
        r[run]["launches"]["server_apply"] for run in ("heterogeneous_sync", "heterogeneous_async"))
    for name, shapes in inputs.codec_shapes.items():
        assert len(shapes) == sum(r[run]["launches"][name]
                                  for run in ("heterogeneous_sync", "heterogeneous_async")), name
    r["heterogeneous_held"] = held = inputs.held("examples",
                                                 torch.Generator(device="cuda").manual_seed(15))
    emit("examples", example="heterogeneous_federation held", **held)
    assert all(held[name] and all(c["bitwise"] for c in held[name]) for name in CODEC_BYTES)
    return r


def phase_examples() -> dict:
    """The port's five examples through their ``main`` on the card (see the
    module docstring): quickstart launches no kernel but the ALiBi training
    pair, serve_batched none; every example that trains photon in bf16
    launches the pair, held to its layers × micro-batches (``without_alibi``);
    heterogeneous_federation's sync run launches ``server_apply`` and
    ``topk_mask_ef`` once per round, its async run each fedcore kernel as
    often as the driver counts it; pretrain_e2e --full launches
    ``server_apply`` once per round at C = 4 over photon-125m, held then to
    its plain version at that width; the socket demos pass."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples import pretrain_e2e, quickstart, serve_batched
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    r = {}
    Q = quickstart  # reduced photon-75m; serve_batched serves and trains nothing
    pair = {"quickstart": (get_config("photon-75m").reduced().n_layers,
                           Q.ROUNDS * Q.CLIENTS * Q.TAU, Q.ROUNDS * EXAMPLE_EVAL_BATCHES),
            "serve_batched": (0, 0, 0)}
    for name, mod in (("quickstart", quickstart), ("serve_batched", serve_batched)):
        _, rows, launches, seconds = _example(mod, [])
        emit("examples", example=name, rows=rows, launches=launches, seconds=seconds)
        assert all(n == 0 for n in without_alibi(launches, *pair[name]).values()), (
            name, launches)
        assert len(rows) == {"quickstart": 6, "serve_batched": 3}[name], rows
        r[name] = {"launches": launches, "seconds": seconds}

    r.update(_examples_heterogeneous())

    # pretrain_e2e --full in a fresh directory: its --resume would pick up a
    # results/e2e_ckpt left there and train nothing
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.reset_peak_memory_stats()
            with _KernelInputs() as widths:
                out, rows, launches, seconds = _example(pretrain_e2e, EXAMPLE_E2E_ARGS)
        finally:
            os.chdir(cwd)
    args = T.parse_args(pretrain_e2e.train_argv(pretrain_e2e.example_args(EXAMPLE_E2E_ARGS)))
    hist = out["history"]
    n_params = sum(x.numel() for x in tree_leaves(out["state"]["params"]))
    Np = -(-n_params // 8192) * 8192
    tokens_per_round = args.clients * args.local_steps * args.batch * args.seq_len
    for row in hist:
        emit("examples", example="pretrain_e2e --full", round=row["round"],
             loss=row["train_loss"], val_ppl=row["val_ppl"], seconds=row["seconds"],
             tokens_per_s=tokens_per_round / row["seconds"])
    e2e = {"arch": args.arch, "n_params": n_params, "Np": Np, "clients": args.clients,
           "rounds": len(hist), "tokens_per_round": tokens_per_round, "total_seconds": seconds,
           "round_seconds": [row["seconds"] for row in hist],
           "final_loss": hist[-1]["train_loss"] if hist else None, "final_line": rows[-1],
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
           "widths": widths.calls}
    emit("examples", example="pretrain_e2e --full", **e2e)
    assert len(hist) == args.rounds and rows[-1].startswith("final: "), rows[-1:]
    assert all(math.isfinite(row["train_loss"]) and math.isfinite(row["val_ppl"])
               for row in hist), hist
    rest = without_alibi(launches, out["model"].cfg.n_layers,
                         args.rounds * args.clients * args.local_steps,
                         args.rounds * args.eval_batches)
    want = {n: args.rounds if n == "server_apply" else 0 for n in rest}
    assert rest == want, (launches, want)
    assert widths.calls == [args.clients] * args.rounds, widths.calls
    e2e["client_steps"] = _client_steps_profile(out["model"], out["state"]["params"], args)
    emit("examples", example="pretrain_e2e --full", client_steps=e2e["client_steps"])
    del out
    gc.collect()
    torch.cuda.empty_cache()
    e2e["held"] = _widths_held(widths.calls, "examples",
                               torch.Generator(device="cuda").manual_seed(14), Np=Np)
    r["pretrain_e2e"] = e2e
    r["socket_federation"] = _socket_demos()
    return r


# ---------------------------------------------------------------------------
# The mesh tooling: production plans, the one-card host mesh, the dry-run CLI
# ---------------------------------------------------------------------------


def _dryrun_cli(argv, out: str) -> dict:
    """``python -m repro_torch.launch.dryrun`` as the CLI runs, writing its
    reports to ``out``: exit code, stdout and the reports by tag."""
    import glob

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                           "--out", out], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=MESH_CLI_TIMEOUT)
    reports = {}
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(path) as f:
            reports[os.path.basename(path)[:-len(".json")]] = json.load(f)
    return {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr,
            "reports": reports, "seconds": time.perf_counter() - t0}


def _update_rel_err(got, want, start) -> float:
    """‖got − want‖ ÷ ‖want − start‖ over leaf lists, in float64: how far the
    update ``got − start`` is from ``want − start``. An update that moves
    nothing, or moves the wrong way, is off by 1 or more."""
    num = sum(float(((g.double() - w.double()) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float(((w.double() - s.double()) ** 2).sum()) for w, s in zip(want, start))
    assert den > 0.0, "the CPU update is zero"
    return math.sqrt(num / den)


def _mesh_check() -> dict:
    """Reduced mamba2-1.3b's federated host-mesh step (float32 compute,
    int8 uplink, --fused-server) on the card and on the CPU from the same
    params and tokens: at round 0 with a zero FedMom lane the new params
    agree to 1e-4; from round ``MESH_ROUND`` with a seeded lane, where the
    step moves them by ~1e-3, the update of the params and of the lane
    agrees to 1e-3 of the CPU update's norm."""
    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, materialize
    from repro_torch.tree import tree_leaves, tree_map

    def lanes(state):
        return [x.detach().cpu().clone() for x in
                tree_leaves(state["params"]) + tree_leaves(state["outer"]["momentum"])]

    cfg = dataclasses.replace(get_config(MESH_ARCH).reduced(), compute_dtype="float32")
    shape = InputShape("train_4k", 64, 4, "train")
    outs, upd = {}, {}
    for dev in ("cpu", "cuda"):
        step = build_train_step(cfg, shape, make_host_mesh(device=dev), tau_lowered=2,
                                fused_server=True, uplink="int8")
        new_state, metrics = step.fn(*materialize(step, dev, seed=0))
        outs[dev] = (tree_leaves(new_state["params"]), float(metrics["train_loss"]))
        args = materialize(step, dev, seed=0)
        gen = torch.Generator().manual_seed(3)
        args[0]["round"] = MESH_ROUND
        args[0]["outer"]["momentum"] = tree_map(
            lambda x: (torch.randn(x.shape, generator=gen) * 3e-4).to(dev), args[0]["params"])
        start = lanes(args[0])
        upd[dev] = (start, lanes(step.fn(*args)[0]))
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(outs["cuda"][0], outs["cpu"][0]))
    n_p = len(outs["cpu"][0])
    (start, got), (_, want) = upd["cuda"], upd["cpu"]
    r = {"max_abs_err_params": err, "loss_cuda": outs["cuda"][1], "loss_cpu": outs["cpu"][1],
         "round": MESH_ROUND,
         "update_rel_err_params": _update_rel_err(got[:n_p], want[:n_p], start[:n_p]),
         "update_rel_err_momentum": _update_rel_err(got[n_p:], want[n_p:], start[n_p:]),
         "update_norm_params": math.sqrt(sum(float(((w.double() - s.double()) ** 2).sum())
                                             for w, s in zip(want[:n_p], start[:n_p])))}
    emit("mesh", check=r)
    assert err <= 1e-4 and abs(r["loss_cuda"] - r["loss_cpu"]) <= 1e-4, r
    assert r["update_rel_err_params"] <= 1e-3 and r["update_rel_err_momentum"] <= 1e-3, r
    return r


def _mesh_step(uplink: str) -> dict:
    """mamba2-1.3b's federated step built by ``launch/steps`` on the one-card
    host mesh (``--fused-server``, ``uplink``), materialized from seed 0, run
    once counted and once timed (``roofline.analysis.measure``); the fedcore
    launches held to exactly one per run of each kernel the path runs, and
    the shape of every ``server_apply`` launch recorded. Under int8 the
    codecs' inputs are copied for holding against the plain versions in a
    third run, so that the counted and timed runs hold no copies; that run
    is under ``torch.profiler``: the device's busy share and the device time
    of ``MESH_PROFILED_OPS``."""
    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.autobatch import verify_micro_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (_target_tokens, arg_bytes_per_device,
                                          build_train_step, materialize)
    from repro_torch.roofline.analysis import analyze_compiled, measure
    from repro_torch.tree import tree_leaves

    cfg = get_config(MESH_ARCH)
    shape = InputShape("train_4k", 4096, MESH_BATCH, "train")
    mesh = make_host_mesh()
    step = build_train_step(cfg, shape, mesh, tau_lowered=MESH_TAU, fused_server=True,
                            uplink=uplink)
    meta = step.meta
    assert (meta["clients"], meta["grad_accum"], meta["fused_server"]) == (
        1, MESH_BATCH, True), meta
    assert _target_tokens(cfg) == 4096 and cfg.n_layers == MAMBA2_LAYERS
    assert tuple(step.args[1]["tokens"].shape) == (MESH_TAU, 1, MESH_BATCH, 1, 4096)
    plan_bytes = arg_bytes_per_device(step)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    args = materialize(step, "cuda", seed=0)
    # past the warmup: at round 0 the one local step (τ = 1) takes the
    # cosine warmup's learning rate at step 0, which is 0, and moves nothing
    args[0]["round"] = MESH_ROUND
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(args[0]["params"]))
    rec = _KernelInputs()
    zero_launches()
    # float32 launches no codec, so there the recorder copies nothing
    with rec if uplink == "float32" else contextlib.nullcontext():
        m = measure(step.fn, args, "cuda", keep_output=True)
    launches = read_launches()
    new_state, metrics = m.output
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(new_state["params"]))
    metrics = {k: float(v) for k, v in metrics.items()}
    m.output = None
    del new_state
    gc.collect()
    torch.cuda.empty_cache()
    prof = None
    if uplink != "float32":
        with rec:
            prof = profile_ops(lambda: step.fn(*args), MESH_PROFILED_OPS)
    del args
    report = analyze_compiled(f"{MESH_ARCH}:train_4k:host:{uplink}", m, mesh.size,
                              model_flops=step.model_flops)
    tokens = meta["tokens_per_call"]
    r = {"uplink": uplink, "global_batch": MESH_BATCH, "tau": MESH_TAU,
         "clients": meta["clients"], "grad_accum": meta["grad_accum"],
         "micro_batch": [1, 4096], "n_layers": cfg.n_layers, "n_params": n_params,
         "param_count": cfg.param_count(), "plan_arg_bytes": plan_bytes,
         "materialize_s": materialize_s, "round_s": m.seconds,
         "tokens_per_s": tokens / m.seconds, "peak_mem_GB": m.peak_memory / 1e9,
         "card_mem_GB": mesh.hbm_bytes / 1e9, "verify_micro_batch": verify_micro_batch(m),
         "counted_flops": m.flops, "counted_bytes": m.bytes, "aten_ops": m.ops,
         "model_flops": step.model_flops, "useful_flops_ratio": report.useful_flops_ratio,
         "t_compute_s": report.t_compute, "t_memory_s": report.t_memory,
         "t_collective_s": report.t_collective, "bottleneck": report.bottleneck,
         # a model, not a measurement: op-boundary bytes over the data sheet's HBM rate
         "t_roofline_over_wall_model": max(report.t_compute, report.t_memory) / m.seconds,
         "kernels_not_counted": m.kernels_not_counted, "launches": launches,
         "server_apply_widths": list(rec.server_apply), "top_ops_by_bytes": m.by_op,
         "train_loss": metrics["train_loss"], "pseudo_grad_norm": metrics["pseudo_grad_norm"],
         "finite_params": finite, "round": MESH_ROUND}
    if prof is not None:
        r["profile"] = dict(prof, busy_share=prof["device_ms"] / prof["profiled_wall_ms"],
                            busy_share_of_timed_wall=prof["device_ms"] / (m.seconds * 1e3))
    emit("mesh", step=r)
    want = MESH_UPLINK_KERNELS[uplink]
    assert m.kernels_not_counted == want, (m.kernels_not_counted, want)
    assert launches == {n: 2 * want.get(n, 0) for n in launches}, launches  # two runs
    assert finite and math.isfinite(r["train_loss"]) and r["pseudo_grad_norm"] > 0, r
    runs = 2 if uplink == "float32" else 1  # the runs the recorder was installed for
    assert rec.server_apply == [rec.server_apply[0]] * runs and all(
        len(v) == runs * want.get(n, 0) for n, v in rec.codec_shapes.items()), (
        rec.server_apply, rec.codec_shapes)
    assert prof is None or prof["device_ms"] > 0, prof
    assert r["verify_micro_batch"], r
    r["rec"] = rec
    return r


def profile_ops(fn, ops) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device time of all
    its kernels (and copies and fills) and the call's wall under the
    profiler; for each aten op in ``ops`` its calls and the device time of
    the kernels it launched itself or through the ops it called; and the
    ten ops of most device time launched by themselves (self). Read from the
    raw profiler events: a kernel links to the op that launched it by
    correlation id, and an op's callers are the ops that enclose it on its
    thread. (``key_averages`` gives the same sums but builds an event object
    per event, minutes at a full-width round's ~2 M events.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    return dict(read_profile(prof, ops), profiled_wall_ms=wall_ms,
                processing_s=time.perf_counter() - t0)


def read_profile(prof, ops) -> dict:
    """``profile_ops``'s sums from a finished ``torch.profiler`` profile."""
    from torch.autograd import DeviceType

    device_ns, by_corr, cpu_ops = 0, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            device_ns += e.duration_ns()
            c = e.linked_correlation_id()
            if c > 0:  # 0: launched by no op the profiler saw
                by_corr[c] = by_corr.get(c, 0) + e.duration_ns()
        elif (e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0
              and not e.is_async() and e.name() != "[memory]"):
            cpu_ops.append((e.start_thread_id(), e.start_ns(), -e.end_ns(), e.name(),
                            e.correlation_id()))
    cpu_ops.sort()
    self_ns, incl_ns, calls = {}, {n: 0 for n in ops}, {n: 0 for n in ops}
    stack, thread = [], None  # (end_ns, name) of the ops enclosing this one
    for tid, start, neg_end, name, corr in cpu_ops:
        if tid != thread:
            stack, thread = [], tid
        while stack and stack[-1][0] <= start:
            stack.pop()
        stack.append((-neg_end, name))
        if name in calls:
            calls[name] += 1
        d = by_corr.get(corr, 0)
        if d:
            self_ns[name] = self_ns.get(name, 0) + d
            for n in {n for _, n in stack if n in incl_ns}:
                incl_ns[n] += d
    top = sorted(self_ns.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": device_ns / 1e6,
            "ops": {n: {"device_ms": incl_ns[n] / 1e6, "calls": calls[n]} for n in ops},
            "top_self_device_ms": {n: v / 1e6 for n, v in top}, "cpu_ops": len(cpu_ops)}


def phase_mesh() -> dict:
    """The mesh tooling on the card: every production plan through the
    dry-run CLI; mamba2-1.3b's federated step on the one-card host mesh
    (float32 and int8 uplinks), its fedcore launches held to their plain
    versions at the shapes the step gave them; the host-mesh CLI at
    mamba2-1.3b's decode_32k and long_500k; the micro-batch estimate."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.autobatch import estimate_micro_batch

    r = {}
    with tempfile.TemporaryDirectory() as out:
        cli = _dryrun_cli(["--arch", "assigned", "--shape", "all", "--multi-pod", "both",
                           "--train-mode", "both"], out)
    n_plans = cli["stdout"].count("not compiled:")
    reps = cli["reports"]
    r["production"] = {
        "rc": cli["rc"], "plans": n_plans, "reports": len(reps), "seconds": cli["seconds"],
        "arg_bytes_per_device": {t: reps[t]["arg_bytes_per_device"] for t in (
            "mamba2-1.3b__train_4k__pod1__federated", "qwen3-1.7b__decode_32k__pod1",
            "llama4-scout-17b-a16e__train_4k__pod2__federated",
            "deepseek-coder-33b__train_4k__pod1__federated") if t in reps},
        "clients": {t: reps[t]["meta"].get("clients") for t in reps if "federated" in t
                    and "pod1" in t}}
    emit("mesh", production=r["production"])
    assert cli["rc"] == 0, cli["stdout"][-3000:] + cli["stderr"][-3000:]
    assert n_plans == len(reps) > 0 and all(v["flops_per_device"] is None
                                            for v in reps.values()), (n_plans, len(reps))

    r["check"] = _mesh_check()
    steps = {}
    for uplink in MESH_UPLINK_KERNELS:
        steps[uplink] = _mesh_step(uplink)
        gc.collect()
        torch.cuda.empty_cache()
    r["steps"] = {u: {k: v for k, v in st.items() if k != "rec"} for u, st in steps.items()}

    # each launch of the two runs held to its plain version at its recorded shape
    gen = torch.Generator(device="cuda").manual_seed(15)
    held = {"int8_quant": [], "int8_dequant": [], "server_apply": []}
    widths = set()
    for uplink, st in steps.items():
        rec = st.pop("rec")
        widths.update(rec.server_apply)
        rec.server_apply.clear()  # server_apply is held below, under FedMom
        for name, cases in rec.held("mesh", gen).items():
            if name in ("int8_quant", "int8_dequant"):
                held[name] += [dict(c, uplink=uplink) for c in cases]
    for C, Np in sorted(widths):  # both uplinks give server_apply the same (C, Np)
        case = _server_apply_case("fedmom", False, gen, C=C, Np=Np)
        held["server_apply"].append({k: case[k] for k in (
            "opt", "C", "Np", "max_abs_err_params", "max_abs_err_lanes", "max_rel_err_norms",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by")})
        emit("mesh", server_apply_held=held["server_apply"][-1])
        del case
        torch.cuda.empty_cache()
    assert len(held["int8_quant"]) == len(held["int8_dequant"]) == 1, held
    assert len(held["server_apply"]) == 1, held
    r["held"] = held

    with tempfile.TemporaryDirectory() as out:
        cli = _dryrun_cli(["--mesh", "host", "--arch", MESH_ARCH, "--shape", MESH_HOST_SHAPES],
                          out)
    r["host_cli"] = {"rc": cli["rc"], "seconds": cli["seconds"], "reports": {
        t: {k: v.get(k) for k in ("peak_memory_per_device", "arg_bytes_per_device",
                                  "flops_per_device", "bytes_per_device", "t_compute_s",
                                  "t_memory_s", "bottleneck", "run_s")}
        | {"seconds": v["measured"]["seconds"],
           "kernels_not_counted": v["measured"]["kernels_not_counted"]}
        for t, v in cli["reports"].items()}}
    emit("mesh", host_cli=r["host_cli"])
    assert cli["rc"] == 0, cli["stdout"][-3000:] + cli["stderr"][-3000:]
    assert len(cli["reports"]) == 2 and all(
        v["peak_memory_per_device"] and not v["measured"]["kernels_not_counted"]
        for v in cli["reports"].values()), cli["stdout"][-3000:]

    cfg = get_config(MESH_ARCH)
    r["estimate_micro_batch"] = estimate_micro_batch(cfg, 4096, model_parallel=1)
    emit("mesh", estimate_micro_batch=r["estimate_micro_batch"],
         card_mem_bytes=torch.cuda.get_device_properties(0).total_memory)
    return r


#: wall seconds of each phase of ``main`` (and its argument), for the timing line
PHASE_SECONDS = {}


def timed(phase, *args):
    """``phase(*args)``, its wall seconds kept in ``PHASE_SECONDS``."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[":".join([phase.__name__[len("phase_"):], *map(str, args)])] = \
        time.perf_counter() - t0
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.aggregator import ASYNC_KERNEL_COUNTERS  # fails outside a checkout

    if sys.argv[1:2] == ["--cli-process"]:  # one process of train_sockets' CLI run
        return cli_process(sys.argv[2:])

    # float32 products in full float32 (the plain versions' and the checks' numerics)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    timed(phase_build)
    sa = timed(phase_server_apply)
    codecs = timed(phase_codecs)
    ssd = timed(phase_ssd_scan)
    flash = timed(phase_flash_attention)
    alibi = timed(phase_flash_alibi)
    decode = timed(phase_flash_decode)
    rms = timed(phase_rmsnorm)
    timed(phase_check)
    timed(phase_serve_check)
    launches = {uplink: timed(phase_train, uplink) for uplink in TRAIN_KERNELS}
    async_launches = {uplink: timed(phase_train_async, uplink)
                      for uplink in ASYNC_KERNEL_COUNTERS}
    timed(phase_train_tiled)
    byz_launches = {uplink: timed(phase_train_byzantine, uplink)
                    for uplink in ("float32", "int8")}
    timed(phase_centralized)
    governed = {uplink: timed(phase_train_governed, uplink) for uplink in ("float32", "int8")}
    cohort = timed(phase_train_cohort)
    sockets = timed(phase_train_sockets)
    mamba2 = timed(phase_serve_mamba2)
    timed(phase_serve_photon)
    whisper = timed(phase_serve_whisper)
    families = timed(phase_serve_families)
    moe = timed(phase_train_moe)
    examples = timed(phase_examples)
    mesh = timed(phase_mesh)
    emit("timing", seconds=PHASE_SECONDS, total=sum(PHASE_SECONDS.values()))

    main_case = sa[("fedavg", False)]  # the main path: FedAvg, no DP noise, C = 4

    def examples_launches(name):  # the in-process example runs' launches
        return {run: examples[run]["launches"][name]
                for run in ("heterogeneous_sync", "heterogeneous_async", "pretrain_e2e")}

    def async_case(r, err_key="max_abs_err"):  # the kernel at the async path's shape
        return {"C": r["C"], "max_abs_err": r[err_key], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"]}

    kernels = [{
        "name": "server_apply",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fedcore_server_apply.cu",
        "replaces": "src/repro/kernels/fedcore/kernel.py:141",
        "launches": launches["float32"]["server_apply"],
        "async_launches": async_launches["float32"]["server_apply"],
        "max_abs_err": main_case["max_abs_err_params"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused mean + update + norms",
        "async_case": async_case(sa[("fedavg", False, ASYNC_BUFFER)], "max_abs_err_params"),
        "byzantine_launches": byz_launches["float32"]["server_apply"],
        "byzantine_int8_launches": byz_launches["int8"]["server_apply"],
        "poisoned_cases": [{k: r[k] for k in ("case", "C", "weights", "max_abs_err")}
                           | {"nan": r["params"]["nan"], "inf": r["params"]["inf"]}
                           for r in sa["poisoned"]],
        # the controller-picked widths: launches per run, and each width held
        "governed_launches": {u: g["launches"]["server_apply"] for u, g in governed.items()},
        "governed_widths": governed["float32"]["widths"],
        "cohort_launches": cohort["launches"]["server_apply"],
        "cohort_widths": cohort["widths"],
        "width_cases": [governed["float32"]["held"][C] for C in sorted(governed["float32"]["held"])]
        + [cohort["held"][C] for C in sorted(cohort["held"])],
        "socket_launches": {u: sockets[u]["launches"]["server_apply"]
                            for u in ("float32", "int8")},
        # deepseek-moe-16b's --fused-server rounds (train_moe): C = 2 over N ≈ 1.09 B
        "moe_launches": moe["launches"]["server_apply"],
        "moe_case": moe["held"][moe["clients"]],
        # the examples (phase examples); pretrain_e2e --full: C = 4 over photon-125m
        "examples_launches": examples_launches("server_apply"),
        "examples_case": examples["pretrain_e2e"]["held"][examples["pretrain_e2e"]["clients"]],
        # heterogeneous_federation's sync and async runs: each (C, Np) held
        "examples_hetero_cases": examples["heterogeneous_held"]["server_apply"],
        # mamba2-1.3b's federated step on the one-card host mesh (phase mesh):
        # launches per run by uplink, and FedMom at C = 1 over its flat N
        "mesh_launches": {u: st["kernels_not_counted"].get("server_apply", 0)
                          for u, st in mesh["steps"].items()},
        "mesh_case": mesh["held"]["server_apply"][0],
    }]
    for name, uplink, line, note in CODEC_KERNELS:
        r = codecs[COHORT][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/fedcore_codecs.cu",
            "replaces": f"src/repro/kernels/fedcore/kernel.py:{line}",
            "launches": launches[uplink][name], "async_launches": async_launches[uplink][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "library_note": note,
            "async_case": async_case(codecs[ASYNC_COHORT][name]),
            "byzantine_launches": byz_launches["int8"][name],
        })
        if name != "sr_bf16":  # no example runs the bf16 uplink
            kernels[-1]["examples_launches"] = examples_launches(name)
            # heterogeneous_federation's launches, on the inputs they were given
            kernels[-1]["examples_cases"] = examples["heterogeneous_held"][name]
        if name in ("int8_quant", "int8_dequant"):  # the mesh phase's int8 step
            kernels[-1]["mesh_launches"] = {
                u: st["kernels_not_counted"].get(name, 0) for u, st in mesh["steps"].items()}
            kernels[-1]["mesh_case"] = mesh["held"][name][0]
        if uplink == "int8":
            kernels[-1]["governed_launches"] = governed["int8"]["launches"][name]
            kernels[-1]["socket_launches"] = sockets["int8"]["launches"][name]
        if name == "int8_dequant":
            kernels[-1]["poisoned_cases"] = [
                {"case": r["case"], "C": r["C"], "bitwise": r["bitwise"], "ms": r["kernel_ms"],
                 "plain_ms": r["plain_ms"]}
                for r in codecs[ASYNC_COHORT]["int8_dequant_poisoned"]]
    kernels.append({
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:88",
        "launches": mamba2["launches"]["ssd_scan"], "max_abs_err": ssd["max_abs_err_y"],
        "ms": ssd["kernel_ms"], "plain_ms": ssd["plain_ms"], "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"], "bound_units": ssd["bound_units"], "library_ms": None,
        "library_note": "no single PyTorch call computes the SSD chunk scan",
        "device_ms": ssd["device_ms"], "host_enqueue_ms": ssd["host_enqueue_ms"],
        "f32_ms": ssd["f32"]["kernel_ms"], "f32_bound_ms": ssd["f32"]["bound_ms"],
        # jamba-v0.1-52b's SSM layer (ds 16, the CUDA-core kernel in bf16)
        "jamba_launches": families["jamba-v0.1-52b"]["launches"]["ssd_scan"],
        "jamba_case": {k: ssd["jamba"][k] for k in (
            "B", "S", "nh", "hd", "G", "ds", "chunk", "dtype", "kernel", "max_abs_err_y",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "bound_units")},
    })
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": whisper["launches"]["flash_attention"], "max_abs_err": flash["max_abs_err"],
        "ms": flash["kernel_ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library_note": "F.scaled_dot_product_attention at the encoder layer's shape",
    })
    for name, key in (("flash_attention_alibi_fwd", "fwd"), ("flash_attention_alibi_bwd", "bwd")):
        head = alibi[FLASH_ALIBI_CASES[0]]  # s2048's layer
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/models/attention.py:104 (sdpa_chunked: causal ALiBi training)",
            # photon-125m's training in pretrain_e2e --full; a call launches
            # the forward once and the backward's two kernels
            "launches": examples["pretrain_e2e"]["launches"][name],
            "examples_launches": {run: examples[run]["launches"][name] for run in (
                "quickstart", "heterogeneous_sync", "heterogeneous_async", "pretrain_e2e")},
            "err": head[f"{key}_err_in_tolerance_units" if key == "fwd" else "bwd_err"],
            "ms": head[f"{key}_ms"], "device_ms": head[f"{key}_device_ms"],
            "host_enqueue_ms": head[f"{key}_host_ms"], "plain_ms": head[f"plain_{key}_ms"],
            "bound_ms": head[f"{key}_bound_ms"], "bound_by": "operations",
            "library_ms": head[f"library_{key}_ms"],
            "library_note": "F.scaled_dot_product_attention, the ALiBi bias and causal mask as "
                            "one bf16 float mask" + (", backward alone" if key == "bwd" else "")
                            + (f"; {head['library_note']}" if head["library_note"] else ""),
            "case": FLASH_ALIBI_CASES[0],
            "cases": [{k: r[k] for k in ("B", "S", "H", "hd", f"{key}_ms", f"{key}_device_ms",
                                         f"{key}_bound_ms", f"plain_{key}_ms",
                                         f"library_{key}_ms")}
                      for r in alibi.values()],
        })
        if key == "fwd":
            kernels[-1]["library_err_in_tolerance_units"] = head["library_err_in_tolerance_units"]
    for name, line, full, source, note in (
            ("flash_decode", 75, decode, "flash_decode.cu",
             "F.scaled_dot_product_attention, boolean mask, enable_gqa=True"),
            ("rmsnorm", 28, rms, "rmsnorm.cu", "F.rms_norm, weight in x's dtype")):
        head = next(iter(full.values()))  # the largest case
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{name}/kernel.py:{line}",
            # the entry-point calls' counts: no model path calls it
            "launches": sum(r["launches"] for r in full.values()),
            "max_abs_err": max(r["max_abs_err"] for r in full.values()),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_note": note, "case": head["case"],
            "cases": [{k: r[k] for k in ("case", "kernel_ms", "device_ms", "host_enqueue_ms",
                                         "ops_scalar_kv_len_host_enqueue_ms", "bound_ms",
                                         "plain_ms", "library_ms") if k in r}
                      for r in full.values()],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
