"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. builds every kernel of koboldcpp_tpu_torch/csrc/ (one nvcc per source,
   all at once) and prints the build time (each source's too) and the
   card's name and power limit;
2. holds each kernel (K1, K2, K7, K3, K4, K5, K8, K6, K9, K10, the q5_k /
   q8_0 bodies K1.q5_k, K7.q5_k, K2.q8_0, K3.q5_k, K3.q8_0, the q2_k /
   q3_k bodies K12.q2_k, K12.q3_k, K13.q2_k, K13.q3_k, and the native IQ
   bodies K12.iq2p, K12.iq3px, K12.iq3ps, K12.iq1p, K13.iq2p, K13.iq3px,
   K13.iq3ps, K13.iq1p at scale groups G = 32, 16 (iq2p) and 8 (iq1p),
   the superblock batched matvec K14 / K14.q5_k at T = 2, 8, 16, the
   FFN megakernel K15b (T=1) / K15a (T = 2, 8), the opt-in bodies
   K12.q6_k_i8f, K12.q3_k_n4, K12.q2_k_n4 (KCPP_KQ_LAYOUT=expanded),
   K13.q4_k_i8 at T = 1, 8, 512 (KCPP_Q4K_LAYOUT=i8), K2.q8_0_bf16 and
   K3's magic-number q4_k body K3.q4_k_magic (KCPP_Q4K_2D=magic), K1
   / K2 / K3 also at DeepSeek-V2-Lite's shapes (`phase_mla_shapes`), with
   the bf16 bodies of K2 / K12.q2_k / K12.q3_k at the 1.1B widths
   (KCPP_MM_I8=0); K9 / K10 also at page size 128; K2.q8_0, K2.q8_0_bf16,
   K12.iq2p at G = 32 and K12.iq1p at G = 8 also at a 70B-class w_down,
   8192 x 28672) against its plain PyTorch version on the card at the
   TinyLlama-1.1B shapes (and
   the fixtures' widths; K4 also at head_dim 128 and 256; K5, K6, K8, K9
   and K10 also at head_dim 80, 96 and 256, at 128 query heads over 8
   kv heads and at the padded head_dims 72 and 512, `HEAD_SHAPES`, K5's
   f32 cache kind at 72 and 512 too; K1, K2 (int8 and bf16 x), K12.q2_k,
   K2.q8_0 and K12.iq1p (G = 8) with x in windows: bit-equal to x whole at
   (8192, 16384), and at in_f 131072 (K2.q8_0: 262144), `phase_windows`;
   K15b / K15a with x in windows bit-equal to x whole, and K15a at a C
   of 26880 whose x goes in windows), with the max error
   against its stated tolerance and the times of the kernel, the plain
   version, one PyTorch library call computing the same function (where
   there is one), and the least time the card could take; every K3 / K13
   body also at T = 16, 128 and a ragged 300 (q4_k and q8_0 at the narrow
   `wo` 256x256 too), twice with the same bits and row for row equal
   across T within the variant `kq_plan` picks (printed per case, with the
   device time alone from CUDA-graph replays, and per T class <= 16 /
   >= 128 after the kernel phases; K4 and every flash-decode case also
   with its device time alone, summed per kernel against SDPA; every K1 /
   K1.q5_k / K7 / K7.q5_k / K17a case too, summed per T class against
   cuBLAS and the bound, `print_q4k_classes`, and every K2 / K12.q2_k /
   K12.q3_k / K17b q6_k, q2_k, q3_k case, summed per class: the 1.1B's
   shapes with int8 and with bf16 x, the fixtures'; every K14, K15, K2.q8_0,
   K12.iq, K12 expanded and K17b q8_0 / IQ case, summed per kernel, also
   without the 70B-class cases, `print_dev_sums`); K7's rows equal
   K1 on each row alone (K7.q5_k K1.q5_k), K14's rows at T = 2 and 8 the
   same tokens' rows at T = 16 and K15a's at T = 2 those at T = 8, bit for
   bit, K2.q8_0 and K2.q8_0_bf16 equal
   their plain versions (the opt-in fixtures' decode step runs K5 over
   their f32 cache),
   and K8 over a shuffled page table equals K5 on the
   same history laid out contiguously, bit for bit; the quantized decode
   kernels (K6, K9, K10) write the same codes and scales as their plain
   versions, bit for bit; then the scan decode path's kernels: every body
   of the layer-stacked matvecs K17a (q4_k int8 and bf16, q5_k) and K17b
   (q6_k, q8_0, q2_k and q3_k each int8 and bf16, and the four IQ
   kinds) on 2 stacked layers at the 1.1B's layer shapes (and the output
   head's for q4_k and q8_0), bit for bit the per-layer K1 / K2 / K12 on
   layers 0 and 1; the pooled-row flash decode K17c over a 22-layer pool
   (B = 1 and 8, head_dim 64 and 128, one dead slot, a bf16 and an f32
   pool), bit for bit K5 on the window's views at layers 0 and 21 with
   every other row unchanged; K5 over an f32 cache; K16 (S = 256 and 2048,
   pos 0, 37, S-1, and a softcap case) against its plain version;
3. serves a synthetic TinyLlama-1.1B q4_k model through Engine: a ~300
   token prompt (prefill through K3 and K4, 22 K4 launches for the one
   chunk from position 0), 32 greedy tokens (K1 and K5), the same prompt
   again (fast-forward) and a prompt that forces a context shift, checks
   that K1, K3, K4 and K5 ran, and that the same engine with flash prefill
   off gives the same tokens (near-ties allowed) and its prefill time; then
   the same with `quantkv=1` (the Q8 cache, K6 in place of K5); then a
   synthetic q4_k model at Phi-3-mini's widths (head_dim 96, 32 kv heads,
   8 layers): a ~300-token prompt and 16 greedy tokens, every decode step
   through K5, the same tokens with K5's plain version in its place;
   then Gemma-2-9B's widths (8 of 42 layers, from the GGUF keys through
   config_from_metadata: 4 sliding-window layers, 4 global, softcaps, tied
   dense head of 256000 x 3584): a 4400-token prompt, so that decode runs
   past the 4096 window, and 16 greedy tokens, every step 4 K5 (the
   global layers) and no K4, the same tokens with K5's plain version; the
   same over the Q8 cache (4 K6 a step); one paged wave of 4 requests
   (4 K8 a step), each getting its single-stream tokens; then Phi-2's
   widths at full depth (32 layers, 32/32 heads of 80, partial rotary,
   parallel residual, non-gated gelu, biases): a 300-token prompt and 16
   greedy tokens, 32 K5 a step, the same tokens with K5's plain version;
   then Mixtral-8x7B's widths (8 of 32 layers, 8 experts of 14336 with
   top-2, dense bf16 expert stacks, q4_k q / k / o, q6_k v and head, from
   the GGUF keys through config_from_metadata), `phase_moe_decode`: a
   300-token prompt (K3, 8 K4 for the chunk from position 0) and 32
   greedy tokens in the device chunk (24 K1, 9 K2, 8 K5 a step), the same
   tokens with K5's plain version and with flash prefill off, then the Q8
   cache (8 K6 a step, against K6's plain version), seeded stochastic
   chunks twice, a paged wave of 4 requests (24 K7, 9 K3, 8 K8 a step),
   each against its single-stream tokens, every comparison run under the
   experts of the run it is held to (router weights within 2^-5 of that
   run's, a token departure's two logits within 2^-3 on that run), the
   dense-EP and sorted-EP forms' last-token logits within 2^-3 of the
   gather form's in the same way, and the MoE block's device time alone, its products' f32
   output against a bf16 one; then DeepSeek-V2-Lite's widths at full
   depth (27 layers, 16 heads of 128 + 64 roped dims over a 512-rank
   latent, a dense lead layer, 64 experts of 1408 top-6 and 2 shared,
   YaRN 40; ~30 GB, from DEEPSEEK_V2_LITE_MD), `phase_deepseek2_decode`:
   a 300-token prompt (K3) and 16 greedy tokens in the host loop (159 K1
   and the head's K2 a step), the same under the first run's experts with
   K1 / K2 / K3's plain versions (`_moe_same`), quantkv=1 (the MLA cache
   stays bf16: the same tokens), seeded stochastic tokens twice, a
   fast-forward of one token, one MoE layer's step in the every-expert and
   the grouped form and the bytes each reads, the MLA attention's and the
   no-kernel projections' device times (these two phases run last of the
   timed ones, and their models stay for profiled windows);
4. serves the same model through BatchedEngine (8 slots, context 2048),
   on the slot cache and on the paged pool (P=64): 8 concurrent greedy
   requests of 100-300 prompt tokens and 32 new tokens each, which must
   get the single-stream Engine's tokens (a step where the two parts must
   be a near-tie of the single-stream logits, and is printed) and the same
   tokens paged as on the slot cache; then 7 greedy + 1 stochastic
   request; prints the aggregate tokens/s, and checks that K7, K8, K5 and
   K3 ran; then over the Q8
   pool (`quantkv=1`, K9) and the Q4 pool (`quantkv=2`, K10): 8 concurrent
   greedy requests of 32 new tokens, each getting the tokens it gets alone
   through the same engine;
   then, under KCPP_FFN_FUSED=1, single-stream (300-token prompt, 32
   greedy tokens: every decode step 22 K15b and 45 K1, against the default
   path's 89 K1; a fast-forwarded repeat; the last prompt token's logits
   within 2e-2 of max |logit| of the unfused forward's) and 8 slots (every
   decode step 22 K15a and 45 K7), and 16 slots under KCPP_SBQ=1 (every
   decode step 89 K14, no K7 or K3): 8 / 16 concurrent greedy requests of
   8 new tokens, each getting the tokens it gets alone through the same
   engine; per-step launches read by wrapping models.llama.forward;
4a. parallel serving (`phase_parallel`, after the scan decode phase): two
   ranks on this one card over gloo (the second a child process), the
   1.1B Q4_K_M drawn on the card, a 300-token prompt and 32 greedy tokens
   under tp=2 (K1 / K2 / K3 / K4 / K5 on each rank's shard shapes, no
   dequant call, wk and wv the only weights kept whole), then the same
   under pp=2 and sp=2, each reply the unsharded engine's (near-ties
   apart), both ranks' launches counted; then tp=2 over the other model
   modules (`_tp_archs`): DeepSeek-V2-Lite widths (the experts over tp;
   TP_DS2_LAYERS of 27 layers), RWKV6 Finch 1.6B (TP_RWKV6_LAYERS of 24),
   nomic-embed-text-v1.5 (full depth) and the tiny bitnet, openelm,
   chameleon_swin, mpt, jais and plamo fixtures, each reply the
   unsharded engine's on the card (near-ties apart; the embeddings within
   4e-2 + 4e-2 |want|), no shard that meets the kernels' rule on the
   dequant path; a world-1 NCCL group's all_reduce / all_gather /
   broadcast;
4b. the launcher's kernel-selection variables (`phase_kernel_vars`, after
   the scan decode phase): the synthetic 1.1B q4_k single-stream under
   KCPP_Q4K_DECODE=0, KCPP_PALLAS_MM=0 (every decode step 89 K3, no K1),
   KCPP_Q4K_2D=magic (the prefill through K3.q4_k_magic, no K3),
   KCPP_Q4K_RAW_X=0 with KCPP_Q4K_I8=0 (K1's bf16 body) and
   KCPP_FLASH_DECODE=0 (K5 as before), and 12 slots under
   KCPP_MATVEC_MAX_T=16 with KCPP_Q4K_I8=0 (K7's bf16 body at T = 12
   where the JAX row-tile rule admits the shape, K3 elsewhere); the
   logits of the prompt's last token against the default variables';
5. serves tests/fixtures/refgguf/tiny-q4_k_m.gguf over HTTP in-process,
   single-stream (checks that K2 ran) and with multiuser=4 (4 concurrent
   requests, each getting the reply it gets alone), each also with
   `--quantkv 1` (K6 single-stream, K9 multiuser);
6. serves the synthetic 1.1B with q6_k, q5_k, q8_0, q2_k, q3_k, iq2p,
   iq3px, iq3ps and then iq1p weights (the IQ kinds at G = 32):
   single-stream (300-token prompt, 32 greedy tokens (q6_k 16),
   fast-forward to the same tokens, near-ties apart; K2 and K3, every
   q6_k decode step 89 K2; q6_k, q2_k and q3_k then 8 tokens under
   KCPP_MM_I8=0, every decode step 89 of the bf16-x body; K1.q5_k and
   K3.q5_k, K2.q8_0 and K3.q8_0, K12 and K13) and batched (8
   slots, 8 concurrent requests of 8 new tokens: K3, K7.q5_k, K3.q8_0,
   K13), each batched request getting its single-stream
   tokens (q5_k) or the tokens it gets alone through the batched engine
   (the other kinds); q5_k also under KCPP_SBQ=1 (8 new tokens, every
   decode step 89 K14.q5_k); then the synthetic 1.1B in each opt-in
   layout, single-stream under its variable (300-token prompt, 16 greedy
   tokens, a fast-forwarded repeat): q6_k / q3_k / q2_k under
   KCPP_KQ_LAYOUT=expanded (every decode step 89 K12.q6_k_i8f / q3_k_n4 /
   q2_k_n4, none of K2 / K12.q3_k / K12.q2_k), q4_k under
   KCPP_Q4K_LAYOUT=i8 (89 K13.q4_k_i8, no K1; prefill chunks through
   K13.q4_k_i8) and q8_0 under KCPP_MM_I8=0 (89 K2.q8_0_bf16, no K2.q8_0),
   the last prompt token's logits within 2e-2 (4e-2 for q6_k_i8f and
   where the model amplifies rounding) of max |logit| of the default
   layout's, and the default layout's decode tok/s
   in the same run; q4_k_i8 also with 8 slots (8 requests of 8 tokens,
   each getting its reply alone); then the scan decode path: the q4_k
   model stacked at full depth (22 layers) over a pooled cache, the
   300-token prompt as one prefill chunk through forward_stacked (K3, no
   K4) and 32 greedy tokens, equal to the unrolled forward's over the slot
   cache (near-ties apart), every decode step 88 K17a + 22 K17c + the
   head's K1 and no K5; the same for a synthetic 1.1B q8_0 at 16 tokens
   (88 K17b.q8_0 a step); the decode tok/s of both paths in turns;
7. serves tiny-q8_0, -q5_1, -q4_0, -iq4_nl and -tq2_0, and
   tests/fixtures/portgguf's tiny-q2_k, -q3_k_m, -iq2_xs, -iq3_xxs and
   -iq1_m, over HTTP, two identical replies each through their kinds'
   bodies (K2.q8_0, K1.q5_k, K1, K12, K13), tiny-q8_0, tiny-q5_1, tiny-q2_k
   and tiny-iq1_m also with multiuser=4; tiny-q6_k and tiny-q3_k_m under
   KCPP_KQ_LAYOUT=expanded, tiny-q4_k_m under KCPP_Q4K_LAYOUT=i8 and
   tiny-q8_0 under KCPP_MM_I8=0, two identical replies each through the
   opt-in bodies; then holds the eight reference
   fixtures' logits on the card against the reference runtime's goldens,
   the five portgguf fixtures' against the JAX package's committed
   logits, and those of tests/fixtures/portgguf/optin.json (five fixtures
   under their variables, a prefill of 11 tokens and one decode step)
   against the JAX package's under the same variables; then serves the
   gemma2, phi2 and mpt Q4_K_M fixtures (tests/fixtures/portgguf/
   archs.json), the mixtral, qwen2moe and grok ones (moe.json) and the
   deepseek2, minicpm3, chameleon (swin norm), openelm, bitnet, jais and
   plamo ones (late.json) over HTTP, two identical replies each (K1 / K3;
   K5 on gemma2's global layer, openelm's full-head layer and the others'
   layers, none on mpt's and jais's ALiBi or MLA), and holds their
   logits to the JAX package's committed ones;
8. the single-stream path's served features on the synthetic 1.1B (q4_k
   layers, a q6_k head), `phase_served_features`: 64 stochastic tokens
   (temperature 0.8, top-p 0.9, min-p 0.05, rep-pen 1.1, a seed) twice,
   the same tokens, with K1 / K2 / K5 launched inside the device chunks;
   top-k 1 gives the greedy chunks' tokens (near-ties allowed); the
   chunk's candidate distribution on the card equals the plain chain's;
   decode tok/s of the greedy chunk, the stochastic chunk and the
   host-sampled loop (KCPP_FAST_DECODE=0) in interleaved pairs;
   save_state after a 300-token prompt, an unrelated prompt, load_state:
   the next 32 greedy tokens and the first logits bit-equal; a smart-context
   session at context 2048 evaluating the prompt tokens the JAX rule
   predicts; at the 1.1B's widths and 2 layers, a rank-8 LoRA merged at
   load within 2^-6 of max |logit| of a hand-merged model (K1 still on the
   packed weights) and a GGJT v3 Q4_0 file's logits bit-equal to the same
   blocks as GGUF; `cli.main([..., "--benchmark"])`; over HTTP the Lite
   page at /, /api/tags, and the profiler routes around one generate
   (a trace naming the port's kernels);
8a. the vision and speech inputs (`phase_llava`, `phase_whisper`, before
   the MoE phases): LLaVA-1.5-7B's widths at full depth (CLIP
   ViT-L/14-336 with the mlp2x_gelu projector, f32, and a LLaMA-2-7B-width
   q4_k_m LM, both drawn on the card): a 640 x 480 PNG's 576 embeddings
   against the same module on the CPU (1e-3 (1 + |want|)), one image
   request (597 prefill rows through K3, 32 greedy tokens through K1 / K2
   / K5) against the plain matmuls (near-ties apart), two image requests
   and a text one together through BatchedEngine on the slot cache and the
   paged pool, equal to single-stream; whisper-small's widths: the encoder
   output and the first decoder logits against the CPU, a 30 s
   `transcribe`, a 75 s `transcribe_verbose` (three windows, the full
   temperature ladder) and one /api/extra/transcribe request; the K5 /
   K6 / K8 / K9 / K10 cases above also take the head_dims 20, 36 and 640
   (`REPAIRED_SHAPES`: pieces narrower than 16 bytes, output columns in
   chunks), and K5 / K6 also 1152, 2048, 4864 and 8192, K8 / K9 / K10 /
   K16 / K17c 1152, 4864 and 8192 (`STREAMED_SHAPES`: the streamed
   instance past head_dim 512, Q, K and V rows in pieces of 128 columns;
   4864 and 8192, `WIDE_SHAPES`, past the old limit of 4800);
8b. the recurrent, embedding and encoder-decoder models
   (`phase_served_text`, `phase_text_decode`, `phase_embed`, after the MLA
   phase): the tiny text fixtures of tests/fixtures/portgguf/text.json
   over HTTP (Mamba, RWKV6 and T5 at Q4_K_M, RWKV-4 as a q8_0 legacy .bin:
   two identical /api/v1/generate replies; nomic-bert: /v1/embeddings and
   a 400 on generate), their logits / hidden states against the JAX
   package's committed ones (2e-2 + 2e-2 |want|); then Mamba-1.4B, RWKV6
   Finch 1.6B, RWKV-4-Pile-1B5 and flan-t5-base at their published
   widths and depth (`TEXT_MODELS`, models/synthetic.py
   `synthetic_text_model`): a 300-token prompt (one 512-row chunk through
   K3 / K3.q8_0; T5's encoder) and 8 greedy one-row decode steps (K1 /
   K2 / K2.q8_0), repeatable, the first 4 of them under the kernels'
   plain versions (near-ties apart), a recurrent state continued by one prompt
   token, the recurrence's and the declined projections' device time
   alone; nomic-embed-text-v1.5: `Engine.embed` and an encode of 300
   tokens through K3 against K3's plain version; their idle shares last
   (`phase_text_profiled`);
9. last, since a profiler session slows every later decode of the
   process: the device idle share under torch.profiler of the synthetic
   1.1B q4_k, 32 fast-forwarded single-stream tokens (with that request's
   tok/s before and after the session, the q4_k matvec rows per token and
   no separate activation-prep launch; then under KCPP_FFN_FUSED=1), the
   300-token prefill as one chunk, and
   32 batched steps of 8 requests (and of 16 under KCPP_SBQ=1), and
   tools/profile_scan.py's scan mode (32 tokens: idle share, top five ops
   per step), the Mixtral-widths model's greedy decode (32 tokens:
   idle share, device busy time a token) and the DeepSeek-V2-Lite one's
   (8 tokens: the same, and the MoE blocks' and the attention's share of
   a token);
10. prints one {"kernels": [...]} line, then the {"ok": true, ...} line.

Any failed check raises, so the script exits nonzero. It exits nonzero,
printing no result, when no GPU is present.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import os
import socket
import sys
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

from koboldcpp_tpu_torch.device import card_info  # noqa: E402
from koboldcpp_tpu_torch.engine import Engine, GenParams  # noqa: E402
from koboldcpp_tpu_torch.engine import batch_engine  # noqa: E402
from koboldcpp_tpu_torch.engine.engine import splice_images  # noqa: E402
from koboldcpp_tpu_torch.models import deepseek2 as ds2  # noqa: E402
from koboldcpp_tpu_torch.models import llama  # noqa: E402
from koboldcpp_tpu_torch.models.config import config_from_metadata  # noqa: E402
from koboldcpp_tpu_torch.models.loader import Model, load_model  # noqa: E402
from koboldcpp_tpu_torch.models.synthetic import (  # noqa: E402
    _MAKERS, DEEPSEEK_V2_LITE_MD, FLAN_T5_BASE_MD, MAMBA_1_4B_MD,
    NOMIC_EMBED_V1_5_MD, RWKV4_PILE_1B5_MD, RWKV6_FINCH_1B6_MD,
    LLAMA2_7B, TINYLLAMA_1_1B, rand_iq, rand_q2k, rand_q3k, rand_q4k,
    rand_q4k_centered, rand_q5k, rand_q6k, rand_q8_0, synthetic_clip,
    synthetic_deepseek2_model, synthetic_model, synthetic_q4_k_m_on_device,
    synthetic_text_model, synthetic_whisper)
from koboldcpp_tpu_torch.kv import paged  # noqa: E402
from koboldcpp_tpu_torch.kv.cache import (  # noqa: E402
    _dequant, _q8, init_cache, init_pool_cache)
from koboldcpp_tpu_torch.ops import _build, flash_decode  # noqa: E402
from koboldcpp_tpu_torch.ops import ffn_fused, flash_prefill  # noqa: E402
from koboldcpp_tpu_torch.ops import moe as moe_ops  # noqa: E402
from koboldcpp_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from koboldcpp_tpu_torch.ops.linear import (  # noqa: E402
    EXPANDED, QTensor, dequant, to_expanded, to_q4_k_i8)
from koboldcpp_tpu_torch.sampling import SamplerParams  # noqa: E402
from koboldcpp_tpu_torch.tools import profile_scan  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12         # H100 SXM dense int8 tensor-core peak
FIX = os.path.join(ROOT, "tests", "fixtures", "refgguf")
PORT_FIX = os.path.join(ROOT, "tests", "fixtures", "portgguf")

KERNELS = {
    "K1": ("q4k_matvec", "koboldcpp_tpu_torch/csrc/q4k_matvec.cu",
           "koboldcpp_tpu/ops/quant_matmul.py:1349"),
    "K2": ("q6k_matvec", "koboldcpp_tpu_torch/csrc/q6k_matvec.cu",
           "koboldcpp_tpu/ops/quant_matmul.py:1489"),
    "K3": ("kq_matmul", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
           "koboldcpp_tpu/ops/quant_matmul.py:1631"),
    "K4": ("flash_prefill", "koboldcpp_tpu_torch/csrc/flash_prefill.cu",
           "koboldcpp_tpu/models/llama.py:52"),
    "K5": ("flash_decode", "koboldcpp_tpu_torch/csrc/flash_decode.cu",
           "koboldcpp_tpu/ops/flash_decode.py:248"),
    "K6": ("flash_decode_q8", "koboldcpp_tpu_torch/csrc/flash_decode.cu",
           "koboldcpp_tpu/ops/flash_decode.py:531"),
    "K7": ("q4k_matvec_t", "koboldcpp_tpu_torch/csrc/q4k_matvec.cu",
           "koboldcpp_tpu/ops/quant_matmul.py:1349"),
    "K8": ("flash_decode_paged", "koboldcpp_tpu_torch/csrc/flash_decode.cu",
           "koboldcpp_tpu/ops/flash_decode.py:718"),
    "K9": ("flash_decode_paged_q8", "koboldcpp_tpu_torch/csrc/flash_decode.cu",
           "koboldcpp_tpu/ops/flash_decode.py:920"),
    "K10": ("flash_decode_paged_q4",
            "koboldcpp_tpu_torch/csrc/flash_decode.cu",
            "koboldcpp_tpu/ops/flash_decode.py:1611"),
    # the q5_k and q8_0 bodies of K1, K7, K2 and K3, each with its own row
    # and launch counter (the rows above count q4_k / q6_k only)
    "K1.q5_k": ("q4k_matvec q5_k", "koboldcpp_tpu_torch/csrc/q4k_matvec.cu",
                "koboldcpp_tpu/ops/quant_matmul.py:599"),
    "K7.q5_k": ("q4k_matvec_t q5_k",
                "koboldcpp_tpu_torch/csrc/q4k_matvec.cu",
                "koboldcpp_tpu/ops/quant_matmul.py:408"),
    "K2.q8_0": ("q8_0_matvec", "koboldcpp_tpu_torch/csrc/q8_0_matvec.cu",
                "koboldcpp_tpu/ops/quant_matmul.py:705"),
    "K3.q5_k": ("kq_matmul q5_k", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                "koboldcpp_tpu/ops/quant_matmul.py:638"),
    "K3.q8_0": ("kq_matmul q8_0", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                "koboldcpp_tpu/ops/quant_matmul.py:1277"),
    # K12 and K13: the q2_k and q3_k bodies of the same two JAX functions
    # (`_packed_matvec` at T=1, `_packed_matmul_2d`)
    "K12.q2_k": ("q23k_matvec q2_k",
                 "koboldcpp_tpu_torch/csrc/q23k_matvec.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:780"),
    "K12.q3_k": ("q23k_matvec q3_k",
                 "koboldcpp_tpu_torch/csrc/q23k_matvec.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:808"),
    "K13.q2_k": ("kq_matmul q2_k", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:1176"),
    "K13.q3_k": ("kq_matmul q3_k", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:1196"),
    # the native IQ bodies of the same two JAX functions
    "K12.iq2p": ("iq_matvec iq2p", "koboldcpp_tpu_torch/csrc/iq_matvec.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:942"),
    "K12.iq3px": ("iq_matvec iq3px", "koboldcpp_tpu_torch/csrc/iq_matvec.cu",
                  "koboldcpp_tpu/ops/quant_matmul.py:984"),
    "K12.iq3ps": ("iq_matvec iq3ps", "koboldcpp_tpu_torch/csrc/iq_matvec.cu",
                  "koboldcpp_tpu/ops/quant_matmul.py:984"),
    "K12.iq1p": ("iq_matvec iq1p", "koboldcpp_tpu_torch/csrc/iq_matvec.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:1010"),
    "K13.iq2p": ("kq_matmul iq2p", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:1038"),
    "K13.iq3px": ("kq_matmul iq3px", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                  "koboldcpp_tpu/ops/quant_matmul.py:1062"),
    "K13.iq3ps": ("kq_matmul iq3ps", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                  "koboldcpp_tpu/ops/quant_matmul.py:1062"),
    "K13.iq1p": ("kq_matmul iq1p", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:1079"),
    # the opt-in decode kernels: the superblock batched matvec (KCPP_SBQ=1)
    # and the FFN megakernel (KCPP_FFN_FUSED=1)
    "K14": ("q4k_matvec_sbq", "koboldcpp_tpu_torch/csrc/q4k_sbq.cu",
            "koboldcpp_tpu/ops/quant_matmul.py:1436"),
    "K14.q5_k": ("q4k_matvec_sbq q5_k", "koboldcpp_tpu_torch/csrc/q4k_sbq.cu",
                 "koboldcpp_tpu/ops/quant_matmul.py:558"),
    "K15a": ("ffn_fused 2<=T<=8", "koboldcpp_tpu_torch/csrc/ffn_fused.cu",
             "koboldcpp_tpu/ops/ffn_fused.py:159"),
    "K15b": ("ffn_fused T=1", "koboldcpp_tpu_torch/csrc/ffn_fused.cu",
             "koboldcpp_tpu/ops/ffn_fused.py:211"),
    # the opt-in bodies: the expanded layouts' T=1 matvec
    # (KCPP_KQ_LAYOUT=expanded), the int8 q4_k layout's 2-D kernel
    # (KCPP_Q4K_LAYOUT=i8, every T) and q8_0's bf16-activation matvec
    # (KCPP_MM_I8=0)
    "K12.q6_k_i8f": ("kq_expanded_matvec q6_k_i8f",
                     "koboldcpp_tpu_torch/csrc/kq_expanded_matvec.cu",
                     "koboldcpp_tpu/ops/quant_matmul.py:837"),
    "K12.q3_k_n4": ("kq_expanded_matvec q3_k_n4",
                    "koboldcpp_tpu_torch/csrc/kq_expanded_matvec.cu",
                    "koboldcpp_tpu/ops/quant_matmul.py:891"),
    "K12.q2_k_n4": ("kq_expanded_matvec q2_k_n4",
                    "koboldcpp_tpu_torch/csrc/kq_expanded_matvec.cu",
                    "koboldcpp_tpu/ops/quant_matmul.py:907"),
    "K13.q4_k_i8": ("kq_matmul q4_k_i8", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                    "koboldcpp_tpu/ops/quant_matmul.py:1285"),
    # K3's magic-number q4_k body (KCPP_Q4K_2D=magic)
    "K3.q4_k_magic": ("kq_matmul q4_k magic",
                      "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
                      "koboldcpp_tpu/ops/quant_matmul.py:616"),
    "K2.q8_0_bf16": ("q8_0_matvec bf16 x",
                     "koboldcpp_tpu_torch/csrc/q8_0_matvec.cu",
                     "koboldcpp_tpu/ops/quant_matmul.py:1094"),
    # the scan decode path: the layer-stacked matvecs (K1's, K2's and
    # K12's bodies on layer li of stacked fields), the pooled-row flash
    # decode; and the read-only single-sequence decode K16 (no path)
    "K17a": ("q4k_matvec_stacked", "koboldcpp_tpu_torch/csrc/q4k_matvec.cu",
             "koboldcpp_tpu/ops/quant_matmul.py:1826"),
    "K17a.q5_k": ("q4k_matvec_stacked q5_k",
                  "koboldcpp_tpu_torch/csrc/q4k_matvec.cu",
                  "koboldcpp_tpu/ops/quant_matmul.py:1826"),
    "K17b": ("matvec_stacked q6_k", "koboldcpp_tpu_torch/csrc/q6k_matvec.cu",
             "koboldcpp_tpu/ops/quant_matmul.py:1883"),
    "K17b.q8_0": ("matvec_stacked q8_0",
                  "koboldcpp_tpu_torch/csrc/q8_0_matvec.cu",
                  "koboldcpp_tpu/ops/quant_matmul.py:1883"),
    "K17b.q8_0_bf16": ("matvec_stacked q8_0 bf16 x",
                       "koboldcpp_tpu_torch/csrc/q8_0_matvec.cu",
                       "koboldcpp_tpu/ops/quant_matmul.py:1883"),
    "K17b.q2_k": ("matvec_stacked q2_k",
                  "koboldcpp_tpu_torch/csrc/q23k_matvec.cu",
                  "koboldcpp_tpu/ops/quant_matmul.py:1883"),
    "K17b.q3_k": ("matvec_stacked q3_k",
                  "koboldcpp_tpu_torch/csrc/q23k_matvec.cu",
                  "koboldcpp_tpu/ops/quant_matmul.py:1883"),
    **{f"K17b.{k}": (f"matvec_stacked {k}",
                     "koboldcpp_tpu_torch/csrc/iq_matvec.cu",
                     "koboldcpp_tpu/ops/quant_matmul.py:1883")
       for k in ("iq2p", "iq3px", "iq3ps", "iq1p")},
    "K17c": ("flash_decode_rows", "koboldcpp_tpu_torch/csrc/flash_decode.cu",
             "koboldcpp_tpu/ops/flash_decode.py:332"),
    "K16": ("flash_decode_single", "koboldcpp_tpu_torch/csrc/flash_decode.cu",
            "koboldcpp_tpu/ops/flash_decode.py:86"),
}
NEAR_TIE = 2 ** -6  # logits this close may pick either token (bf16 steps)
# greedy tokens per request in phases 3-4 (the q4_k main path); 32, not
# 128, to keep the whole script within its time budget
DEPTH = 32
CASES: dict[str, list[dict]] = {k: [] for k in KERNELS}

_flush = None


def _flush_buffer() -> torch.Tensor:
    """256 MiB, zeroed before a timed call to push the 50 MB L2 out."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEV)
    return _flush


def _time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, L2 flushed before each call (the
    decode loop streams every weight from HBM once per token)."""
    _flush_buffer()
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bound_ms(nbytes: int, flops: int = 0,
              peak: float = BF16_FLOPS) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tf, "operations") if tf > tb else (tb, "bytes")


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _record(kid: str, what: str, err: float, tol: float, kernel, plain,
            library, nbytes: int, flops: int = 0,
            peak: float = BF16_FLOPS, dev: bool = False) -> None:
    """library: one PyTorch call computing the same function, or None
    where there is none. dev: also time the kernel and the library call
    on the device alone (`_dev_ms`)."""
    _check(err <= tol, f"{kid} {what}: max error {err} > {tol}")
    bound, by = _bound_ms(nbytes, flops, peak)
    case = {"case": what, "max_abs_err": err, "tol": tol,
            "ms": _time_ms(kernel), "plain_ms": _time_ms(plain, 5),
            "library_ms": None if library is None else _time_ms(library),
            "bound_ms": bound, "bound_by": by}
    CASES[kid].append(case)
    lib = ("none" if library is None
           else f"{case['library_ms']:.4f} ms")
    print(f"{kid} {what}: max_abs_err {err:.3g} (tol {tol:.3g}) "
          f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
          f"library {lib}, bound {bound:.4f} ms ({by})", flush=True)
    if dev:
        case["dev_ms"] = _dev_ms(kernel)
        case["dev_library_ms"] = _dev_ms(library)
        print(f"  device alone: kernel {case['dev_ms']:.4f} ms, library "
              f"{case['dev_library_ms']:.4f} ms", flush=True)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# the fields only K14 reads (the superblock factors of a K-quant file), and
# the one it does not (the bf16 scale they round to)
_SBQ_FIELDS = ("sc", "d")


def _wbytes(qt, sbq: bool = False) -> int:
    """The bytes of the packed fields a kernel reads: K14 (sbq) the codes,
    sc, d and min; K12 expanded its expanded plane, scale and min; every
    other kernel the codes, scale and min."""
    if qt.kind in EXPANDED:
        return _nbytes(*(qt.data[n] for n in ("q", "n4", "scale", "min")
                         if n in qt.data))
    return _nbytes(*(t for n, t in qt.data.items()
                     if (n != "scale" if sbq else n not in _SBQ_FIELDS)))


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions at the 1.1B shapes
# ---------------------------------------------------------------------------

def _i8(x) -> bool:
    """The dispatch's activation variant: int8 from in_f 512 up."""
    return x.shape[-1] >= 512


def phase_matvec(rng) -> None:
    """The T=1 bodies at the 1.1B shapes (and some fixture shapes): K1, K2,
    K1.q5_k, K2.q8_0, K12.q2_k, K12.q3_k with the dispatch's activation
    variant; K2 / K12.q2_k / K12.q3_k also with bf16 activations at the
    1.1B widths (KCPP_MM_I8=0), K2.q8_0_bf16 (KCPP_MM_I8=0) and K12
    expanded (KCPP_KQ_LAYOUT=expanded)."""
    C, F, V = 2048, 5632, 32000
    shapes = {"wqkv": (2560, C), "w_gateup": (2 * F, C), "wo": (C, C),
              "w_down": (C, F), "output": (V, C),
              # the served fixtures' shapes (bf16 variant below 512)
              "fixture wqkv": (512, 256), "fixture wo": (256, 256),
              "fixture ffn_down": (256, 512), "fixture output": (512, 256),
              # a 70B-class w_down: x's codes alone 28 KB (bf16 x 56 KB)
              "70B w_down": (8192, 28672)}
    big = ("wqkv", "w_gateup", "w_down", "output")
    five = ("wqkv", "w_gateup", "wo", "w_down", "output")
    bf16 = " bf16 x"  # the KCPP_MM_I8=0 variant of an int8-default body
    for kid, maker, wrapper, plain, names, tag in (
            ("K1", rand_q4k, lambda x, qt: qm.q4k_matvec(x, qt, _i8(x)),
             lambda x, qt: qm.q4k_matvec_plain(x, qt, _i8(x)),
             ("wqkv", "w_gateup", "wo", "w_down", "output", "fixture wqkv",
              "fixture wo"), ""),
            ("K2", rand_q6k, lambda x, qt: qm.q6k_matvec(x, qt, _i8(x)),
             lambda x, qt: qm.q6k_matvec_plain(x, qt, _i8(x)),
             five + ("fixture output", "fixture ffn_down"), ""),
            ("K1.q5_k", rand_q5k, lambda x, qt: qm.q4k_matvec(x, qt, _i8(x)),
             lambda x, qt: qm.q4k_matvec_plain(x, qt, _i8(x)),
             big + ("fixture wqkv", "fixture ffn_down"), ""),
            ("K2.q8_0", rand_q8_0, qm.q8_0_matvec, qm.q8_0_matvec_plain,
             big + ("fixture wqkv", "fixture ffn_down", "70B w_down"), ""),
            ("K12.q2_k", rand_q2k, lambda x, qt: qm.q23k_matvec(x, qt, _i8(x)),
             lambda x, qt: qm.q23k_matvec_plain(x, qt, _i8(x)),
             big + ("wo", "fixture wqkv", "fixture wo", "fixture ffn_down"),
             ""),
            ("K12.q3_k", rand_q3k, lambda x, qt: qm.q23k_matvec(x, qt, _i8(x)),
             lambda x, qt: qm.q23k_matvec_plain(x, qt, _i8(x)),
             big + ("wo", "fixture wqkv", "fixture wo",
                    "fixture ffn_down"), ""),
            ("K2", rand_q6k, lambda x, qt: qm.q6k_matvec(x, qt, False),
             lambda x, qt: qm.q6k_matvec_plain(x, qt, False), five, bf16),
            ("K12.q2_k", rand_q2k, lambda x, qt: qm.q23k_matvec(x, qt, False),
             lambda x, qt: qm.q23k_matvec_plain(x, qt, False), five, bf16),
            ("K12.q3_k", rand_q3k, lambda x, qt: qm.q23k_matvec(x, qt, False),
             lambda x, qt: qm.q23k_matvec_plain(x, qt, False), five, bf16),
            ("K2.q8_0_bf16", rand_q8_0,
             lambda x, qt: qm.q8_0_matvec(x, qt, False),
             lambda x, qt: qm.q8_0_matvec_plain(x, qt, False),
             five + ("70B w_down",), ""),
            *((f"K12.{kind}", _MAKERS[kind], qm.kq_expanded_matvec,
               qm.kq_expanded_matvec_plain, five, "")
              for kind in ("q6_k_i8f", "q3_k_n4", "q2_k_n4"))):
        for name in names:
            out_f, in_f = shapes[name]
            qt = maker(rng, out_f, in_f, DEV)
            x = torch.from_numpy(rng.standard_normal(in_f).astype(
                np.float32)).to(DEV).bfloat16()
            y = wrapper(x, qt)
            ref = plain(x, qt)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            if kid in ("K2.q8_0", "K2.q8_0_bf16"):
                # the same int8 codes and exact int32 group dots (bf16 x:
                # exact f32 products), and the kernel's summation order
                # repeated: bit for bit
                tol = 0.0
            else:
                # int8 group dots are exact on both sides (bf16 variant: f32
                # dots of the same values); f32 sums in another order, bf16
                # output: one bf16 rounding step of the largest |y|
                tol = 2 ** -7 * ref.float().abs().max().item()
            w = dequant(qt)
            xr = x.view(1, in_f)
            q45, rowmv = kid in Q4K_KIDS, kid in ROWMV_KIDS
            _record(kid, f"{name} {out_f}x{in_f} T=1{tag}", err, tol,
                    lambda: wrapper(x, qt), lambda: plain(x, qt),
                    lambda: torch.matmul(xr, w.t()),
                    _wbytes(qt) + _nbytes(x) + out_f * 2, dev=True)
            if q45:
                _q4k_class(kid, name, 1, _i8(x))
            elif rowmv:
                _rowmv_class(kid, name, _i8(x) and not tag)
            del w


K7_SHAPES = (("wqkv", (2560, 2048)), ("w_gateup", (11264, 2048)),
             ("wo", (2048, 2048)), ("w_down", (2048, 5632)),
             ("output", (32000, 2048)))
# (name, (out_f, in_f), T, int8 activations)
K7_CASES = [(name, shape, T, True) for name, shape in K7_SHAPES
            for T in (2, 4, 8)]
K7_CASES += [(name, shape, T, False) for name, shape in (
    ("fixture wqkv", (512, 256)), ("fixture wo", (256, 256))) for T in (2, 4)]
# a tp=2 row shard of the fixtures' w_down (256 x 512) takes its whole
# weight's int8 variant at in_f 256
K7_CASES += [("fixture w_down shard", (256, 256), T, True) for T in (2, 8)]
# the bf16 body past 8 tokens (KCPP_MATVEC_MAX_T, KCPP_Q4K_I8=0) at the
# 1.1B's in_f-2048 shapes, the 12-slot step of phase_kernel_vars included
K7_CASES += [(name, shape, T, False) for name, shape in K7_SHAPES[:3]
             for T in (12, 16, 21)]


def phase_batched_matvec(rng) -> None:
    """K7 and K7.q5_k at the 1.1B shapes at T = 2, 4, 8 (int8 variant), at
    the fixtures' in_f 256 at T = 2, 4 (bf16 variant), at a row shard of
    the fixtures' w_down at T = 2, 8 (int8 variant at in_f 256) and at
    the 1.1B's wqkv / w_gateup / wo at T = 12, 16, 21 (bf16 variant past
    8 tokens: two and three grid rows, the last one partial); each row
    must equal K1 (K1.q5_k) on that row alone, bit for bit."""
    for kid, maker in (("K7", rand_q4k), ("K7.q5_k", rand_q5k)):
        for name, (out_f, in_f), T, i8 in K7_CASES:
            qt = maker(rng, out_f, in_f, DEV)
            x = torch.from_numpy(rng.standard_normal((T, in_f)).astype(
                np.float32)).to(DEV).bfloat16()
            y = qm.q4k_matvec_t(x, qt, i8)
            ref = qm.q4k_matvec_t_plain(x, qt, i8)
            alone = [qm.q4k_matvec(x[t], qt, i8) for t in range(T)]
            torch.cuda.synchronize()
            for t in range(T):
                _check(torch.equal(y[t:t + 1], alone[t]),
                       f"{kid} {name} T={T}: row {t} differs from K1 on it "
                       "alone")
            # K1's tolerance: exact int8 group dots (bf16 variant: f32 dots
            # of the same values), f32 sums in another order, bf16 output
            err = (y.float() - ref.float()).abs().max().item()
            tol = 2 ** -7 * ref.float().abs().max().item()
            w = dequant(qt)
            _record(kid, f"{name} {out_f}x{in_f} T={T}", err, tol,
                    lambda: qm.q4k_matvec_t(x, qt, i8),
                    lambda: qm.q4k_matvec_t_plain(x, qt, i8),
                    lambda: torch.matmul(x, w.t()),
                    _wbytes(qt) + _nbytes(x) + T * out_f * 2, dev=True)
            _q4k_class(kid, name, T, i8, in_f)
            del w


def phase_sbq(rng) -> None:
    """K14 and K14.q5_k at the 1.1B's five projection shapes (every in_f is
    2048 or 5632), T = 2, 8, 16 (the 16-slot decode step) on the prefixes
    of one x, against the plain version on the same inputs, each also timed
    on the device alone; a token's row is the same bits at T = 2, 8 and 16
    (`sbq_plan`: the sums' order depends on in_f alone). Both kinds also at
    a Llama-2-7B w_down (4096, 11008) and a Llama-3-70B w_down (8192,
    28672), where 16 tokens' codes of every column do not fit a block and x
    goes in windows (`kwin` K steps; at the 70B's T = 8 too, and with more
    than one tile a block there: each tile quantizes every window anew)."""
    wide = (("7B w_down", (4096, 11008)), ("70B w_down", (8192, 28672)))
    for kid, maker in (("K14", rand_q4k), ("K14.q5_k", rand_q5k)):
        for name, (out_f, in_f) in K7_SHAPES + wide:
            qt = maker(rng, out_f, in_f, DEV)
            w = dequant(qt)
            xmax = torch.from_numpy(rng.standard_normal((16, in_f)).astype(
                np.float32)).to(DEV).bfloat16()
            ys = {}
            for T in (2, 8, 16):
                x = xmax[:T].contiguous()
                y = ys[T] = qm.q4k_matvec_sbq(x, qt)
                ref = qm.q4k_matvec_sbq_plain(x, qt)
                torch.cuda.synchronize()
                # the same int8 codes and exact integer segment dots on both
                # sides; f32 combines in another order, bf16 output: one
                # bf16 rounding step of the largest |y|
                err = (y.float() - ref.float()).abs().max().item()
                tol = 2 ** -7 * ref.float().abs().max().item()
                plan = qm.sbq_plan(T, out_f, in_f, qt.kind == "q5_k")
                win = (f" [x in windows of {plan.kwin} of {plan.ksteps} K "
                       "steps]" if plan.kwin < plan.ksteps else "")
                _record(kid, f"{name} {out_f}x{in_f} T={T}{win}", err, tol,
                        lambda: qm.q4k_matvec_sbq(x, qt),
                        lambda: qm.q4k_matvec_sbq_plain(x, qt),
                        lambda: torch.matmul(x, w.t()),
                        _wbytes(qt, sbq=True) + _nbytes(x) + T * out_f * 2,
                        2 * T * in_f * out_f, INT8_OPS, dev=True)
            for T in (2, 8):
                _check(torch.equal(ys[T], ys[16][:T]),
                       f"{kid} {name}: rows at T={T} differ from the same "
                       "tokens' rows at T=16")
            del w


def phase_ffn_fused(rng) -> None:
    """K15b at T=1 and K15a at T = 2, 8 over the 1.1B's q4_k FFN (w_gateup
    (11264, 2048), w_down (2048, 5632)), on the prefixes of one x, against
    the plain version, each also timed on the device alone; the library
    op is cuBLAS over the pre-dequantized weights with silu * mul between.
    K15a's rows at T = 2 are the same bits as those tokens' rows at T = 8."""
    C, F = 2048, 5632
    gu = rand_q4k(rng, 2 * F, C, DEV)
    dn = rand_q4k(rng, C, F, DEV)
    wg, wd = dequant(gu), dequant(dn)

    def library(x):
        h = torch.matmul(x, wg.t())
        return torch.matmul(torch.nn.functional.silu(h[:, :F]) * h[:, F:],
                            wd.t())

    xmax = torch.from_numpy(rng.standard_normal((8, C)).astype(
        np.float32)).to(DEV).bfloat16()
    ys = {}
    for T in (1, 2, 8):
        kid = "K15b" if T == 1 else "K15a"
        x = xmax[:T].contiguous()
        y = ys[T] = ffn_fused.ffn_fused_call(x, gu, dn)
        ref = ffn_fused.ffn_fused_plain(x, gu, dn)
        torch.cuda.synchronize()
        # f32 gate/up and sums in another order: a bf16(a) or a group sum
        # may round the other way, then the bf16 output: one bf16 step of
        # the largest |y|
        err = (y.float() - ref.float()).abs().max().item()
        tol = 2 ** -7 * ref.float().abs().max().item()
        _record(kid, f"w_gateup {2 * F}x{C} + w_down {C}x{F} T={T}", err,
                tol, lambda: ffn_fused.ffn_fused_call(x, gu, dn),
                lambda: ffn_fused.ffn_fused_plain(x, gu, dn),
                lambda: library(x),
                _wbytes(gu) + _wbytes(dn) + _nbytes(x) + T * C * 2,
                2 * T * 3 * C * F, dev=True)
    _check(torch.equal(ys[2], ys[8][:2]),
           "K15a: rows at T=2 differ from the same tokens' rows at T=8")
    del wg, wd
    _ffn_windows(rng, library)


def _ffn_windows(rng, library) -> None:
    """K15 with x in windows (`ffn_plan`'s kwin): at T = 1 and 2 over a
    (C, F) = (4096, 8192) FFN, x forced into windows of one of its two K
    steps (four phase-1 tiles a block, so each tile preps every window
    anew) is the same bits as x whole; K15a at T = 3 over C = 26880 (F =
    1024), a width `_tiles` takes whose x a block cannot hold whole,
    against the plain version."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    C, F = 4096, 8192
    gu, dn = rand_q4k(rng, 2 * F, C, DEV), rand_q4k(rng, C, F, DEV)
    for T in (1, 2):
        x = torch.from_numpy(rng.standard_normal((T, C)).astype(
            np.float32)).to(DEV).bfloat16()
        whole = ffn_fused._ffn_launch(x, gu, dn, sms)
        win = ffn_fused._ffn_launch(x, gu, dn, sms, kwin=1)
        torch.cuda.synchronize()
        _check(ffn_fused.ffn_plan(T, C, F, sms).kwin == 2,
               f"K15 C={C} T={T}: x should fit whole")
        _check(torch.equal(whole, win), f"K15 C={C} F={F} T={T}: x in "
               "windows of 1 K step differs from x whole")
        print(f"K15 C={C} F={F} T={T}: x in windows of 1 of 2 K steps equal "
              "to x whole bit for bit", flush=True)
    del gu, dn
    torch.cuda.empty_cache()
    T, C, F = 3, 26880, 1024
    plan = ffn_fused.ffn_plan(T, C, F, sms)
    _check(plan.kwin < plan.ksteps1, f"K15a C={C}: x should go in windows")
    gu, dn = rand_q4k(rng, 2 * F, C, DEV), rand_q4k(rng, C, F, DEV)
    wg, wd = dequant(gu), dequant(dn)
    x = torch.from_numpy(rng.standard_normal((T, C)).astype(
        np.float32)).to(DEV).bfloat16()
    y = ffn_fused.ffn_fused_call(x, gu, dn)
    ref = ffn_fused.ffn_fused_plain(x, gu, dn)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    tol = 2 ** -7 * ref.float().abs().max().item()

    def lib(x=x):
        h = torch.matmul(x, wg.t())
        return torch.matmul(torch.nn.functional.silu(h[:, :F]) * h[:, F:],
                            wd.t())

    _record("K15a", f"w_gateup {2 * F}x{C} + w_down {C}x{F} T={T} [x in "
            f"windows of {plan.kwin} of {plan.ksteps1} K steps]", err, tol,
            lambda: ffn_fused.ffn_fused_call(x, gu, dn),
            lambda: ffn_fused.ffn_fused_plain(x, gu, dn), lib,
            _wbytes(gu) + _wbytes(dn) + _nbytes(x) + T * C * 2,
            2 * T * 3 * C * F)
    del gu, dn, wg, wd
    torch.cuda.empty_cache()


# the T=1 bodies with x in windows (`q4k_plan` / `rowmv_plan`): (kernel,
# maker, launch(x, qt, kwin), plain(x, qt), the wide in_f); int8 x unless
# the kernel's name says otherwise
def _win_launches():
    def q6k(i8):
        return (lambda x, qt, kw: qm._q6k_launch(x, qt, i8, "K2", None, kw),
                lambda x, qt: qm.q6k_matvec_plain(x, qt, i8))
    return (
        ("K1", rand_q4k,
         lambda x, qt, kw: qm._q4k_launch(x[None], qt, True, "K1", None, kw),
         lambda x, qt: qm.q4k_matvec_plain(x, qt, True), 131072),
        ("K2", rand_q6k, *q6k(True), 131072),
        ("K2 bf16 x", rand_q6k, *q6k(False), 131072),
        ("K12.q2_k", rand_q2k,
         lambda x, qt, kw: qm._q23k_launch(x, qt, True, "K12", None, kw),
         lambda x, qt: qm.q23k_matvec_plain(x, qt, True), 131072),
        ("K2.q8_0", rand_q8_0,
         lambda x, qt, kw: qm._q8_0_launch(x, qt, True, "K2.q8_0", None, kw),
         lambda x, qt: qm.q8_0_matvec_plain(x, qt, True), 262144),
        ("K12.iq1p", lambda rng, o, i, dev: rand_iq(rng, o, i, dev, "iq1p",
                                                     8),
         lambda x, qt, kw: qm._iq_launch(x, qt, "K12", None, kw),
         qm.iq_matvec_plain, 131072))


def phase_windows(rng) -> None:
    """The T=1 matvecs where x does not fit a block whole: K1 (q4_k), K2
    (q6_k, int8 and bf16 x), K12.q2_k, K2.q8_0 and K12.iq1p (G = 8). At
    (8192, 16384), which every body takes whole, x forced into windows of 3
    K steps (a short last one; about two tiles a block, so each tile preps
    every window anew) is the same bits as x whole; at out_f 256 and in_f
    131072 (K2.q8_0: 262144), where the plan windows x itself, the kernel
    against its plain version (K2.q8_0 bit for bit, the rest within 2^-7 of
    max |y|)."""
    for kid, maker, launch, plain, wide in _win_launches():
        rec = kid.split()[0]
        out_f, in_f = 8192, 16384
        qt = maker(rng, out_f, in_f, DEV)
        x = torch.from_numpy(rng.standard_normal(in_f).astype(
            np.float32)).to(DEV).bfloat16()
        whole, win = launch(x, qt, 0), launch(x, qt, 3)
        torch.cuda.synchronize()
        _check(torch.equal(whole, win), f"{kid} ({out_f}, {in_f}): x in "
               "windows of 3 K steps differs from x whole")
        print(f"{kid} ({out_f}, {in_f}): x in windows of 3 K steps equal to "
              "x whole bit for bit", flush=True)
        del qt
        out_f, in_f = 256, wide
        qt = maker(rng, out_f, in_f, DEV)
        x = torch.from_numpy(rng.standard_normal(in_f).astype(
            np.float32)).to(DEV).bfloat16()
        i8 = "bf16" not in kid
        kind = qt.kind
        plan = (qm.q4k_plan(1, out_f, in_f) if kind == "q4_k" else
                qm.rowmv_plan(kind, out_f, in_f, i8,
                              qm.iq_group(qt) if kind in qm.IQ_KINDS else 0))
        _check(plan.kwin < plan.ksteps, f"{kid} in_f {in_f}: x should go "
               "in windows")
        y = launch(x, qt, 0)
        ref = plain(x, qt)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        tol = 0.0 if rec == "K2.q8_0" else \
            2 ** -7 * ref.float().abs().max().item()
        w = dequant(qt)
        xr = x.view(1, in_f)
        _record(rec, f"{out_f}x{in_f} T=1{kid[len(rec):]} [x in windows of "
                f"{plan.kwin} of {plan.ksteps} K steps]", err, tol,
                lambda: launch(x, qt, 0), lambda: plain(x, qt),
                lambda: torch.matmul(xr, w.t()),
                _wbytes(qt) + _nbytes(x) + out_f * 2)
        del qt, w
        torch.cuda.empty_cache()


def _dev_ms(fn, reps: int = 10) -> float:
    """Device time of one call, L2 flushed before it: CUDA-graph replays of
    (flush, fn) less those of the flush alone, so the host's launch time
    (the wrapper's Python) is not counted."""
    flush = _flush_buffer()
    fn()
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    with torch.cuda.graph(graphs[0]):
        flush.zero_()
    with torch.cuda.graph(graphs[1]):
        flush.zero_()
        fn()
    ms = []
    for g in graphs:
        g.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            g.replay()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b) / reps)
    del graphs
    return ms[1] - ms[0]


def _event_ms(fn, reps: int = 5) -> float:
    """Time of one call between CUDA events, for a call that reads the
    device on the host (which a CUDA graph cannot capture): the L2 is not
    flushed and host gaps inside the call count."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# the attention kernels whose cases carry device-alone times
ATTENTION = ("K4", "K5", "K6", "K8", "K9", "K10", "K16", "K17c")


def print_attention_sums() -> None:
    """Per attention kernel: kernel / library summed over its cases, as
    `_record` times them (host included) and on the device alone."""
    for kid in ATTENTION:
        cases = CASES[kid]
        k, lib = (sum(c[n] for c in cases) for n in ("ms", "library_ms"))
        dk, dl = (sum(c[n] for c in cases) for n in ("dev_ms",
                                                     "dev_library_ms"))
        bound = sum(c["bound_ms"] for c in cases)
        print(f"{kid} ({len(cases)} cases): kernel / library {k:.4f} / "
              f"{lib:.4f} ms = {k / max(lib, 1e-9):.2f}x; device alone "
              f"{dk:.4f} / {dl:.4f} ms = {dk / max(dl, 1e-9):.2f}x; bound "
              f"{bound:.4f} ms", flush=True)


# K3 / K13 per T class (<= 16, >= 128): (kernel, library) ms as `_record`
# times them and the same on the device alone (`_dev_ms`), summed
KQ_CLASSES: dict = {}


def _kq_cases(kid: str, label: str, qt, Ts, rng, xmax=None,
              magic: bool = False) -> None:
    """kq_matmul of qt at each T of Ts against its plain version, on the
    prefixes of one x: twice with the same bits, and row for row equal to
    the call at every other T of the same variant (`kq_plan`). magic: the
    magic-number q4_k body (K3.q4_k_magic)."""
    plain_fn = qm.kq_matmul_magic_plain if magic else qm.kq_matmul_plain
    out_f, in_f = qt.shape
    G = qm.iq_group(qt) if qt.kind in qm.IQ_KINDS else 0
    if xmax is None:
        xmax = torch.from_numpy((rng.standard_normal((max(Ts), in_f)) * 0.5)
                                .astype(np.float32)).to(DEV).bfloat16()
    w = dequant(qt)
    ys: dict[int, torch.Tensor] = {}
    for T in Ts:
        x = xmax[:T].contiguous()
        plan = qm.kq_plan(qt.kind, T, out_f, in_f, G)
        y = qm.kq_matmul(x, qt, magic)
        y2 = qm.kq_matmul(x, qt, magic)
        ref = plain_fn(x, qt)
        torch.cuda.synchronize()
        _check(torch.equal(y, y2), f"{kid} {label} T={T}: two calls differ")
        for t0, y0 in ys.items():
            if qm.kq_plan(qt.kind, t0, out_f, in_f, G).variant == plan.variant:
                lo, hi = (y0, y) if t0 < T else (y, y0)
                _check(torch.equal(lo, hi[:lo.shape[0]]),
                       f"{kid} {label}: rows of T={min(t0, T)} differ inside "
                       f"T={max(t0, T)} ({plan.variant})")
        ys[T] = y
        # the same bf16 weights and group sums, f32 accumulation in another
        # order, bf16 output: one rounding step of max |y|
        err = (y.float() - ref.float()).abs().max().item()
        tol = 2 ** -7 * ref.float().abs().max().item()
        _record(kid, f"{label} {out_f}x{in_f} T={T} [{plan.variant} "
                f"{plan.rows}x{plan.tokens} split {plan.split}]", err, tol,
                lambda: qm.kq_matmul(x, qt, magic),
                lambda: plain_fn(x, qt),
                lambda: torch.matmul(x, w.t()),
                _wbytes(qt) + _nbytes(x) + T * out_f * 2,
                2 * T * in_f * out_f, dev=True)
        case = CASES[kid][-1]
        if T <= 16 or T >= 128:
            sums = KQ_CLASSES.setdefault((kid, "<=16" if T <= 16 else ">=128"),
                                         [0.0, 0.0, 0.0, 0.0, 0])
            for i, k in enumerate(("ms", "library_ms", "dev_ms",
                                   "dev_library_ms")):
                sums[i] += case[k]
            sums[4] += 1
    del w


def print_kq_classes() -> None:
    """The K3 / K13 sums per T class, with kernel / library ratios."""
    for (kid, cls), (k, lib, dk, dl, n) in sorted(KQ_CLASSES.items()):
        print(f"{kid} T{cls} ({n} cases): kernel / library {k:.4f} / "
              f"{lib:.4f} ms = {k / lib:.2f}x; device alone {dk:.4f} / "
              f"{dl:.4f} ms = {dk / dl:.2f}x", flush=True)


# K1 / K1.q5_k / K7 / K7.q5_k (and K17a) per class: the int8 cases at
# T = 1 and at T = 2-8, those at T = 8 alone, K1's four wide 1.1B shapes
# (wqkv, w_gateup, w_down, output) and the bf16-x (fixture) cases; each
# [ms, library ms, device-alone ms, device-alone library ms, bound ms, n]
Q4K_KIDS = ("K1", "K1.q5_k", "K7", "K7.q5_k")
Q4K_CLASSES: dict = {}
_K1_WIDE = ("wqkv", "w_gateup", "w_down", "output")


def _q4k_class(kid: str, name: str, T: int, i8: bool,
               in_f: int = 0) -> None:
    """Add the last case of `kid` to its classes (Q4K_CLASSES): the bf16
    and the int8 cases at in_f 256 (the fixtures' and a shard's) apart
    from the 1.1B's."""
    if not i8:
        classes = ["bf16 x" if in_f < 512 else "bf16 x T>8"]
    elif in_f == 256:
        classes = ["int8 x shard"]
    else:
        classes = ["T=1" if T == 1 else "T=2-8"] + (["T=8"] if T == 8 else [])
        if T == 1 and name in _K1_WIDE:
            classes.append("T=1 wqkv+w_gateup+w_down+output")
    _add_to_classes(kid, classes)


def _add_to_classes(kid: str, classes) -> None:
    """Add the last case of `kid` to each class of `classes`."""
    case = CASES[kid][-1]
    for cls in classes:
        sums = Q4K_CLASSES.setdefault((kid, cls), [0.0] * 5 + [0])
        for i, k in enumerate(("ms", "library_ms", "dev_ms", "dev_library_ms",
                               "bound_ms")):
            sums[i] += case[k]
        sums[5] += 1


# K2 / K12.q2_k / K12.q3_k and their K17b entries (csrc/rowmv.cuh) per
# class: the int8 and the bf16-x cases at the 1.1B's shapes (five, or
# K17b's four layer shapes), and the fixtures' (in_f 256-512), in
# Q4K_CLASSES too
ROWMV_KIDS = ("K2", "K12.q2_k", "K12.q3_k", "K17b", "K17b.q2_k", "K17b.q3_k")


def _rowmv_class(kid: str, name: str, i8: bool) -> None:
    """Add the last case of `kid` to its class (Q4K_CLASSES)."""
    _add_to_classes(kid, ["fixtures" if name.startswith("fixture")
                          else "1.1B int8" if i8 else "1.1B bf16 x"])


# K14 / K15, K2.q8_0 / K12.iq and their K17b entries (rowmv_g.cuh) and the
# expanded layouts' K12 (rowmv.cuh), summed per kernel over their cases on
# the device alone against the library op and the bound, so that the next
# piece of work is ranked by device time
DEV_SUM_KIDS = ("K14", "K14.q5_k", "K15a", "K15b", "K2.q8_0",
                "K2.q8_0_bf16", "K12.iq2p", "K12.iq3px", "K12.iq3ps",
                "K12.iq1p", "K12.q6_k_i8f", "K12.q3_k_n4", "K12.q2_k_n4",
                "K17b.q8_0", "K17b.q8_0_bf16", "K17b.iq2p", "K17b.iq3px",
                "K17b.iq3ps", "K17b.iq1p")


def print_dev_sums() -> None:
    """Per kernel of DEV_SUM_KIDS: kernel / library summed over its cases,
    host included and on the device alone, and device alone / bound; where
    a kernel has 70B-class cases, the same without them too (the case set
    of the earlier runs). Cases timed on the device alone only (not the
    windowed ones of `phase_windows` / `_ffn_windows`)."""
    for kid in DEV_SUM_KIDS:
        timed = [c for c in CASES[kid] if "dev_ms" in c]
        sets = [("", timed)]
        small = [c for c in timed if "70B" not in c["case"]]
        if len(small) < len(timed):
            sets.append((" without 70B", small))
        for tag, cases in sets:
            k, lib, dk, dl, b = (sum(c[n] for c in cases) for n in (
                "ms", "library_ms", "dev_ms", "dev_library_ms", "bound_ms"))
            print(f"{kid}{tag} ({len(cases)} cases): kernel / library "
                  f"{k:.4f} / {lib:.4f} ms = {k / lib:.2f}x; device alone "
                  f"{dk:.4f} / {dl:.4f} ms = {dk / dl:.2f}x; bound {b:.4f} "
                  f"ms, device alone / bound {dk / b:.2f}x", flush=True)


def print_q4k_classes() -> None:
    """The K1 / K7 (and K17a) and K2 / K12 (and K17b) sums per class:
    kernel / library host included and on the device alone, and kernel
    (device alone) / bound."""
    for (kid, cls), (k, lib, dk, dl, b, n) in Q4K_CLASSES.items():
        print(f"{kid} {cls} ({n} cases): kernel / library {k:.4f} / "
              f"{lib:.4f} ms = {k / lib:.2f}x; device alone {dk:.4f} / "
              f"{dl:.4f} ms = {dk / dl:.2f}x; bound {b:.4f} ms, device alone "
              f"/ bound {dk / b:.2f}x", flush=True)


def phase_kq_matmul(rng) -> None:
    """K3 (q4_k, q6_k) and K3.q5_k / K3.q8_0 / K13.q2_k / K13.q3_k at the
    1.1B's gate+up and down shapes, T = 8, 16, 128, 300 (the scan path's
    unpadded prefill chunk) and 512; K13.q4_k_i8 (KCPP_Q4K_LAYOUT=i8:
    decode, batched decode and prefill) at T = 1, 8, 512 at all five 1.1B
    shapes and T = 16, 128, 300 at the two; q4_k and q8_0 at the narrow
    fixture `wo` 256x256, T = 16; K3.q4_k_magic (KCPP_Q4K_2D=magic) at
    K3's q4_k shapes and T = 1, 8 (swap), 16, 128, 300, 512, and at the
    1.1B's wqkv and wo at T = 300 (the rest of the magic prefill chunk). Each against
    its plain version, twice with the same bits, row for row equal across
    T within a variant."""
    for name, shape in (("wqkv", (2560, 2048)), ("wo", (2048, 2048))):
        _kq_cases("K3.q4_k_magic", f"q4_k {name}", rand_q4k(rng, *shape, DEV),
                  (300,), rng, magic=True)
    for name, shape in (("w_gateup", (11264, 2048)), ("w_down", (2048, 5632))):
        _kq_cases("K3.q4_k_magic", f"q4_k {name}", rand_q4k(rng, *shape, DEV),
                  (1, 8, 16, 128, 300, 512), rng, magic=True)
        for kid, kind, maker, Ts in (
                ("K3", "q4_k", rand_q4k, (16, 128, 300, 512)),
                ("K3", "q6_k", rand_q6k, (16, 128, 300, 512)),
                ("K3.q5_k", "q5_k", rand_q5k, (8, 16, 128, 300, 512)),
                ("K3.q8_0", "q8_0", rand_q8_0, (8, 16, 128, 300, 512)),
                ("K13.q2_k", "q2_k", rand_q2k, (8, 16, 128, 300, 512)),
                ("K13.q3_k", "q3_k", rand_q3k, (8, 16, 128, 300, 512))):
            _kq_cases(kid, f"{kind} {name}", maker(rng, *shape, DEV), Ts, rng)
    for name, shape in K7_SHAPES:
        Ts = ((1, 8, 16, 128, 300, 512) if name in ("w_gateup", "w_down")
              else (1, 8, 512))
        _kq_cases("K13.q4_k_i8", f"q4_k_i8 {name}",
                  _MAKERS["q4_k_i8"](rng, *shape, DEV), Ts, rng)
    for kid, kind, maker in (("K3", "q4_k", rand_q4k),
                             ("K3.q8_0", "q8_0", rand_q8_0)):
        _kq_cases(kid, f"{kind} fixture wo", maker(rng, 256, 256, DEV), (16,),
                  rng)


# DeepSeek-V2-Lite's shapes that the MLA path sends to K1 / K2 / K3 beyond
# the 1.1B's (wo is 2048 x 2048 there too): wq, wkv_b (in_f 512, the
# kv_lora_rank), the shared experts' gate / up and down, and the q6_k head
MLA_SHAPES = {"wq": (3072, 2048), "wkv_b": (4096, 512),
              "shexp gate": (2816, 2048), "shexp down": (2048, 2816)}
MLA_HEAD = (102400, 2048)


def phase_mla_shapes(rng) -> None:
    """K1 (zero-mean q4_k, as the MLA model's) at MLA_SHAPES T=1, K2 at the
    q6_k head, and K3 at T = 512 (the 300-token prompt's bucket) at
    MLA_SHAPES, each against its plain version with the tolerances of
    phase_matvec / _kq_cases."""
    cases = [("K1", f"MLA {n}", rand_q4k_centered, shape,
              lambda x, qt: qm.q4k_matvec(x, qt, True),
              lambda x, qt: qm.q4k_matvec_plain(x, qt, True))
             for n, shape in MLA_SHAPES.items()]
    cases.append(("K2", "MLA output", rand_q6k, MLA_HEAD,
                  lambda x, qt: qm.q6k_matvec(x, qt, True),
                  lambda x, qt: qm.q6k_matvec_plain(x, qt, True)))
    for kid, name, maker, (out_f, in_f), wrapper, plain in cases:
        qt = maker(rng, out_f, in_f, DEV)
        x = torch.from_numpy(rng.standard_normal(in_f).astype(
            np.float32)).to(DEV).bfloat16()
        y, ref = wrapper(x, qt), plain(x, qt)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        w = dequant(qt)
        xr = x.view(1, in_f)
        _record(kid, f"{name} {out_f}x{in_f} T=1", err,
                2 ** -7 * ref.float().abs().max().item(),
                lambda: wrapper(x, qt), lambda: plain(x, qt),
                lambda: torch.matmul(xr, w.t()),
                _wbytes(qt) + _nbytes(x) + out_f * 2, dev=True)
        del w
    for name, shape in MLA_SHAPES.items():
        if name != "shexp gate":
            _kq_cases("K3", f"q4_k MLA {name}",
                      rand_q4k_centered(rng, *shape, DEV), (512,), rng)


# (kind, scale group G) -> the K12.iq cases (name, (out_f, in_f)) and the
# K13.iq cases (name, (out_f, in_f), T); G = 32 is IQ2_XXS, IQ3_XXS/S and
# IQ1_S, G = 16 IQ2_XS/S, G = 8 IQ1_M. T=1 goes to K12.iq from in_f 32 G
# up; the narrow fixture shapes below that run K13.iq at T=1.
_IQ_K12 = (("wo", (2048, 2048)), ("wk", (256, 2048)),
           ("w_gateup", (11264, 2048)), ("w_down", (2048, 5632)),
           ("output", (32000, 2048)))
_IQ_K13 = tuple((name, shape, (8, 16, 128, 300, 512)) for name, shape in (
    ("w_gateup", (11264, 2048)), ("w_down", (2048, 5632))))
_IQ_70B = (("70B w_down", (8192, 28672)),)
IQ_CASES = (
    ("iq2p", 32, _IQ_K12 + _IQ_70B,
     _IQ_K13 + (("fixture wo", (256, 256), (1,)),)),
    ("iq3px", 32, _IQ_K12, _IQ_K13 + (("fixture w_gateup", (1024, 256), (1,)),)),
    ("iq3ps", 32, _IQ_K12, _IQ_K13),
    ("iq1p", 32, _IQ_K12, _IQ_K13),
    ("iq2p", 16, _IQ_K12[2:4] + (("fixture ffn_down", (256, 512)),),
     (("w_gateup", (11264, 2048), (8, 16, 128, 300, 512)),)),
    ("iq1p", 8, _IQ_K12[2:4] + (("fixture w_gateup", (1024, 256)),)
     + _IQ_70B,
     (("w_gateup", (11264, 2048), (8, 16, 128, 300, 512)),)))


def phase_iq_kernels(rng) -> None:
    """K12.iq and K13.iq for each IQ kind (IQ_CASES) at the 1.1B shapes, T
    = 1 (K12.iq; K13.iq at the narrow fixture shapes) and T = 8 / 16 / 128
    / 300 / 512 (K13.iq, as `_kq_cases` holds them), with G = 16 (iq2p) and
    G = 8 (iq1p) beside G = 32."""
    for kind, G, k12_cases, k13_cases in IQ_CASES:
        for name, (out_f, in_f) in k12_cases:
            qt = rand_iq(rng, out_f, in_f, DEV, kind, G)
            x = torch.from_numpy(rng.standard_normal(in_f).astype(
                np.float32)).to(DEV).bfloat16()
            y = qm.iq_matvec(x, qt)
            ref = qm.iq_matvec_plain(x, qt)
            torch.cuda.synchronize()
            # exact int32 group dots on both sides; f32 sums in another
            # order, bf16 output: one bf16 rounding step of the largest |y|
            err = (y.float() - ref.float()).abs().max().item()
            tol = 2 ** -7 * ref.float().abs().max().item()
            w = dequant(qt)
            xr = x.view(1, in_f)
            _record(f"K12.{kind}", f"G={G} {name} {out_f}x{in_f} T=1", err,
                    tol, lambda: qm.iq_matvec(x, qt),
                    lambda: qm.iq_matvec_plain(x, qt),
                    lambda: torch.matmul(xr, w.t()),
                    _wbytes(qt) + _nbytes(x) + out_f * 2, dev=True)
            del w
        for name, shape, Ts in k13_cases:
            _kq_cases(f"K13.{kind}", f"{kind} G={G} {name}",
                      rand_iq(rng, *shape, DEV, kind, G), Ts, rng)


# head shapes the port serves beyond the 1.1B's 32/4/64 (H, Hkv, head_dim):
# D = 80 (32/8), Phi-3-mini's 32/32/96, gemma-2-9b's 16/8/256,
# Llama-3.1-405B's 128/8/128 (G = 16, G * D = 2048), two that the tiles
# pad: D = 72 (32/16, padded to 80) and D = 512 (8/1), and Phi-2's 32/32/80
HEAD_SHAPES = ((32, 8, 80), (32, 32, 96), (16, 8, 256), (128, 8, 128),
               (32, 16, 72), (8, 1, 512), (32, 32, 80))
# head_dims that the JAX package sends to its kernels (Hkv * D % 128 == 0)
# beyond a multiple of 8 up to 512: 20 and 36 (a head's bytes not a
# multiple of 16: narrower pieces, Q and the new rows by plain loads) and
# 640, 1152 and 2048 (the streamed instance: output columns in chunks of
# 128, Q, K and V rows through shared memory in pieces of 128 columns),
# and 4864 and 8192, past the limit of 4800 that the Q tile set before Q
# streamed too (WIDE_SHAPES)
WIDE_SHAPES = ((1, 1, 4864), (1, 1, 8192))
REPAIRED_SHAPES = ((32, 32, 20), (32, 32, 36), (1, 1, 640), (1, 1, 1152),
                   (1, 1, 2048)) + WIDE_SHAPES
# the streamed instance's shapes for the members the list above does not
# cover (K8, K9, K10 with its nibbles unpacked as they are copied, K16,
# K17c)
STREAMED_SHAPES = ((1, 1, 1152),) + WIDE_SHAPES
# Gemma-2's attention softcap, which K5 / K6 / K8 take on its global layers
GEMMA2_SOFTCAP = 50.0
# positions of the 8-sequence cases: pos 0, page boundaries, the last row,
# a dead slot
BATCH_POSITIONS = (0, 1, 63, 64, 700, 2047, -1, 256)


def phase_flash_decode(rng) -> None:
    # the 1.1B shape at four positions with nearly flat scores; then peaked
    # scores (see _peak) at two of them, and B=2 at head_dim 128 (an 8B-class
    # GQA shape) with one live and one dead (pos < 0) sequence; then each of
    # HEAD_SHAPES, one sequence peaked at pos 700 and eight at mixed
    # positions; last, the f32 cache kind at the padded head_dims (at D =
    # 512 its tiles take 32 rows)
    for B, S, H, Hkv, D, positions, peaked in (
            [(1, 2048, 32, 4, 64, (p,), False) for p in (0, 1, 700, 2047)]
            + [(1, 2048, 32, 4, 64, (p,), True) for p in (700, 2047)]
            + [(2, 4096, 32, 8, 128, (3000, -1), True)]
            + [c for H, Hkv, D in HEAD_SHAPES + REPAIRED_SHAPES
               for c in ((1, 2048, H, Hkv, D, (700,), True),
                         (8, 2048, H, Hkv, D, BATCH_POSITIONS, True))]):
        _flash_decode_case(rng, B, S, H, Hkv, D, positions, peaked)
    for H, Hkv, D in ((32, 16, 72), (8, 1, 512), (1, 1, 640), (1, 1, 1152),
                      (1, 1, 2048)) + WIDE_SHAPES:
        _flash_decode_case(rng, 8, 2048, H, Hkv, D, BATCH_POSITIONS, True,
                           torch.float32)
    # Gemma-2's global layers: 16/8/256 under the softcap, past its window
    for B, positions in ((1, (4500,)), (4, (4500, 4096, 100, -1))):
        _flash_decode_case(rng, B, 8192, 16, 8, 256, positions, True,
                           softcap=GEMMA2_SOFTCAP)


def _peak(rng, q, kc, positions, G: int) -> None:
    """Make a few rows dominate the softmax, so that a row read or missed
    by mistake moves the output by far more than rounding can. Each kv
    group's query heads share a direction u (score of a row c*u ~ c); the
    rows around the first two and the last split boundaries of the
    kernel's plan (`flash_decode.decode_plan`) below the history end, and
    the last history row, get c in [8, 9]; the global maximum (c = 9.5)
    sits in the last split; the row at pos (stale before this step's
    write) and the one after it get c = 11 and must not be read. The other
    rows score ~N(0, 0.7^2)."""
    B, H, D = q.shape
    S, Hkv = kc.shape[1], H // G
    rps, _ = flash_decode.decode_plan(B, Hkv, S)
    u = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((B, Hkv, D)).astype(np.float32)),
        dim=-1).to(q.device)
    q.copy_((D ** 0.5 * u).repeat_interleave(G, 1) + q.float())
    kv = kc.view(B, S, Hkv, D)
    for b, p in enumerate(positions):
        n_hist = min(p, S) if p >= 0 else S
        if n_hist == 0:  # nothing is read: only the stale rows below
            kv[b, :2] = 11.0 * u[b]
            continue
        last = (n_hist - 1) // rps * rps
        read = sorted({r for j in {rps, 2 * rps, last} if 0 < j < n_hist
                       for r in (j - 1, j)} | {n_hist - 1})
        for r, c in zip(read, np.linspace(8.0, 9.0, len(read))):
            kv[b, r] = c * u[b]
        kv[b, (last + n_hist) // 2] = 9.5 * u[b]
        for r in (p, p + 1) if p >= 0 else ():
            if r < S:
                kv[b, r] = 11.0 * u[b]


# tensors past this many elements are drawn on the card: numpy's draw of a
# 22-layer pool at head_dim 8192 takes tens of seconds on the host
HOST_DRAW_MAX = 1 << 24


def _normal(rng, shape, s: float = 1.0, dtype=torch.bfloat16):
    """N(0, s^2) values of `shape` on the card in `dtype`: numpy's draw
    from rng, or past HOST_DRAW_MAX elements a torch.Generator's on the
    card, seeded from rng."""
    if math.prod(shape) <= HOST_DRAW_MAX:
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(DEV).to(dtype)
    g = torch.Generator(device=DEV).manual_seed(int(rng.integers(2 ** 31)))
    return (torch.randn(shape, generator=g, device=DEV) * s).to(dtype)


def _flash_decode_case(rng, B, S, H, Hkv, D, positions, peaked,
                       cache_dtype=torch.bfloat16,
                       softcap: float = 0.0) -> None:
    """K5 on one case; cache_dtype float32: the f32 cache kind (values
    drawn in f32, this step's row widened from bf16). With a softcap the
    case is checked and timed, and has no library call (SDPA takes no
    softcap): it is printed, not added to K5's row."""
    KD = Hkv * D
    scale = D ** -0.5

    def t(shape, s=1.0, dtype=torch.bfloat16):
        return _normal(rng, shape, s, dtype)

    kc0 = t((B, S, KD), 0.5, cache_dtype)
    vc0 = t((B, S, KD), 0.5, cache_dtype)
    q, kn, vn = t((B, H, D)), t((B, Hkv, D)), t((B, Hkv, D))
    if peaked:
        _peak(rng, q, kc0, positions, H // Hkv)
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    kc, vc = kc0.clone(), vc0.clone()
    out, _, _ = flash_decode.decode_attention_batched(
        q, kn, vn, kc, vc, pos, H, Hkv, scale, softcap)
    kr, vr = kc0.clone(), vc0.clone()
    ref = flash_decode.decode_attention_batched_plain(q, kn, vn, kr, vr, pos,
                                                      H, Hkv, scale, softcap)
    # W = sum_s p_s |v_s| / l per output element: the same softmax over |V|
    w = flash_decode.decode_attention_batched_plain(
        q, kn, vn.abs(), kc0.clone(), vc0.abs(), pos, H, Hkv, scale, softcap)
    torch.cuda.synchronize()
    what = (f"B={B} S={S} H={H} Hkv={Hkv} D={D} pos={positions}"
            + (" peaked" if peaked else "")
            + (" f32 cache" if cache_dtype == torch.float32 else "")
            + (f" softcap {softcap:g}" if softcap else ""))
    # the cache row at pos is this step's K/V, every other row unchanged
    want_k, want_v = kc0.clone(), vc0.clone()
    for b, p in enumerate(positions):
        if 0 <= p < S:
            want_k[b, p] = kn[b].reshape(KD)
            want_v[b, p] = vn[b].reshape(KD)
    _check(torch.equal(kc, want_k) and torch.equal(vc, want_v),
           f"K5 {what}: the cache is not the old one plus the rows at pos")
    _check(torch.equal(kc, kr) and torch.equal(vc, vr),
           f"K5 {what}: kernel and plain caches differ")
    # each p is rounded to bf16 (2^-8 relative) against another running max
    # on each side, so output element d moves by at most 2^-7 * W_d; 5% more
    # for f32 sums and exp in another order. Checked element by element.
    tol_el = 2 ** -7 * 1.05 * w
    diff = (out - ref).abs()
    ratio = diff / tol_el.clamp_min(1e-30)
    worst = ratio.max().item()
    _check(worst <= 1.0, f"K5 {what}: max |err| / elementwise tol {worst}")
    err = diff.max().item()
    tol = tol_el.flatten()[diff.argmax()].item()
    print(f"K5 {what}: worst |err| / (2^-7 * 1.05 * W) {worst:.3g}",
          flush=True)
    if softcap:
        ms = _time_ms(lambda: flash_decode.decode_attention_batched(
            q, kn, vn, kc, vc, pos, H, Hkv, scale, softcap))
        print(f"K5 {what}: kernel {ms:.4f} ms (no library call takes the "
              f"softcap)", flush=True)
        return
    # library: SDPA over the rows each query attends: the live prefix of the
    # updated cache (history + this row), or for a dead sequence (pos < 0)
    # every cache row plus this step's row
    ql = q.view(B, H, 1, D).to(cache_dtype)
    if B == 1 and positions[0] >= 0:
        n = positions[0] + 1
        kq = want_k[:, :n].view(B, n, Hkv, D).transpose(1, 2)
        vq = want_v[:, :n].view(B, n, Hkv, D).transpose(1, 2)
        mask = None
    else:
        kq = torch.cat([want_k, kn.reshape(B, 1, KD).to(cache_dtype)],
                       1).view(B, S + 1, Hkv, D).transpose(1, 2)
        vq = torch.cat([want_v, vn.reshape(B, 1, KD).to(cache_dtype)],
                       1).view(B, S + 1, Hkv, D).transpose(1, 2)
        cols = torch.arange(S + 1, device=DEV)
        mask = torch.stack([cols <= p if p >= 0 else cols >= 0
                            for p in positions])[:, None, None, :]
    hist_rows = sum(min(p, S) if p >= 0 else S for p in positions)
    n_written = sum(0 <= p < S for p in positions)
    el = kc0.element_size()
    _record("K5", what, err, tol,
            lambda: flash_decode.decode_attention_batched(
                q, kn, vn, kc, vc, pos, H, Hkv, scale),
            lambda: flash_decode.decode_attention_batched_plain(
                q, kn, vn, kr, vr, pos, H, Hkv, scale),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                ql, kq, vq, attn_mask=mask, scale=scale, enable_gqa=True),
            2 * hist_rows * KD * el + _nbytes(q, kn, vn, pos) + B * H * D * 4
            + 2 * n_written * KD * el, dev=True)


def phase_paged_flash_decode(rng) -> None:
    """K8 at the 1.1B's batched decode shape: B=8, H=32, Hkv=4, D=64, pages
    of P=64 rows, MP=32 pages (S=2048) per sequence, handed out in a
    shuffled order; flat scores, then peaked ones (see _peak); then peaked
    at each of HEAD_SHAPES."""
    for peaked in (False, True):
        _paged_case(rng, 8, 32, 4, 64, 64, 32, BATCH_POSITIONS, peaked)
    for H, Hkv, D in HEAD_SHAPES + REPAIRED_SHAPES[:1] + STREAMED_SHAPES:
        _paged_case(rng, 8, H, Hkv, D, 64, 32, BATCH_POSITIONS, True)


def _paged_case(rng, B, H, Hkv, D, P, MP, positions, peaked) -> None:
    S, KD, NP = MP * P, Hkv * D, B * MP
    scale = D ** -0.5

    def t(shape, s=1.0):
        return _normal(rng, shape, s)

    # each sequence's history, contiguous (for K5), then scattered into the
    # pool through a shuffled page table (for K8)
    kc0, vc0 = t((B, S, KD), 0.5), t((B, S, KD), 0.5)
    q, kn, vn = t((B, H, D)), t((B, Hkv, D)), t((B, Hkv, D))
    if peaked:
        _peak(rng, q, kc0, positions, H // Hkv)
    table = torch.from_numpy(rng.permutation(NP).reshape(B, MP).astype(
        np.int32)).to(DEV)
    rows = flash_decode._page_rows(table, P, NP)  # (B, S) pool rows
    kp0 = torch.zeros((NP * P, KD), dtype=torch.bfloat16, device=DEV)
    vp0 = torch.zeros_like(kp0)
    kp0[rows.reshape(-1)] = kc0.reshape(-1, KD)
    vp0[rows.reshape(-1)] = vc0.reshape(-1, KD)
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    kp, vp = kp0.clone(), vp0.clone()
    out, _, _ = flash_decode.decode_attention_paged(
        q, kn, vn, kp, vp, table, pos, H, Hkv, P, scale)
    kr, vr = kp0.clone(), vp0.clone()
    ref = flash_decode.decode_attention_paged_plain(
        q, kn, vn, kr, vr, table, pos, H, Hkv, P, scale)
    w = flash_decode.decode_attention_paged_plain(
        q, kn, vn.abs(), kp0.clone(), vp0.abs(), table, pos, H, Hkv, P, scale)
    kc, vc = kc0.clone(), vc0.clone()
    out5, _, _ = flash_decode.decode_attention_batched(
        q, kn, vn, kc, vc, pos, H, Hkv, scale)
    torch.cuda.synchronize()
    what = (f"B={B} H={H} Hkv={Hkv} D={D} P={P} MP={MP} pos={positions}"
            + (" peaked" if peaked else ""))
    # the pool changed at the row each live position maps to, only
    want_k, want_v = kp0.clone(), vp0.clone()
    for b, p in enumerate(positions):
        if 0 <= p < S:
            want_k[rows[b, p]] = kn[b].reshape(KD)
            want_v[rows[b, p]] = vn[b].reshape(KD)
    _check(torch.equal(kp, want_k) and torch.equal(vp, want_v),
           f"K8 {what}: the pool is not the old one plus the rows at pos")
    _check(torch.equal(kp, kr) and torch.equal(vp, vr),
           f"K8 {what}: kernel and plain pools differ")
    live = [b for b, p in enumerate(positions) if p >= 0]
    _check(torch.equal(out[live], out5[live]),
           f"K8 {what}: differs from K5 on the same history")
    # K5's per-element bound (see _flash_decode_case)
    tol_el = 2 ** -7 * 1.05 * w
    diff = (out - ref).abs()
    worst = (diff / tol_el.clamp_min(1e-30)).max().item()
    _check(worst <= 1.0, f"K8 {what}: max |err| / elementwise tol {worst}")
    err = diff.max().item()
    tol = tol_el.flatten()[diff.argmax()].item()
    k5_ms = _time_ms(lambda: flash_decode.decode_attention_batched(
        q, kn, vn, kc, vc, pos, H, Hkv, scale))
    print(f"K8 {what}: worst |err| / (2^-7 * 1.05 * W) {worst:.3g}; live "
          f"slots equal K5 bit for bit; K5 on the same history laid out "
          f"contiguously {k5_ms:.4f} ms", flush=True)
    hist_rows = sum(min(p, S) if p >= 0 else S for p in positions)
    n_written = sum(0 <= p < S for p in positions)
    # library: SDPA over the same history laid out contiguously (the updated
    # cache plus this step's row), masked as in _flash_decode_case
    ql = q.view(B, H, 1, D)
    kq = torch.cat([kc, kn.reshape(B, 1, KD)], 1).view(
        B, S + 1, Hkv, D).transpose(1, 2)
    vq = torch.cat([vc, vn.reshape(B, 1, KD)], 1).view(
        B, S + 1, Hkv, D).transpose(1, 2)
    cols = torch.arange(S + 1, device=DEV)
    mask = torch.stack([cols <= p if p >= 0 else cols >= 0
                        for p in positions])[:, None, None, :]
    _record("K8", what, err, tol,
            lambda: flash_decode.decode_attention_paged(
                q, kn, vn, kp, vp, table, pos, H, Hkv, P, scale),
            lambda: flash_decode.decode_attention_paged_plain(
                q, kn, vn, kr, vr, table, pos, H, Hkv, P, scale),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                ql, kq, vq, attn_mask=mask, scale=scale, enable_gqa=True),
            2 * hist_rows * KD * 2 + _nbytes(q, kn, vn, pos, table)
            + B * H * D * 4 + 2 * n_written * KD * 2, dev=True)


def _bf16(rng, shape, s=1.0):
    return _normal(rng, shape, s)


def phase_flash_prefill(rng) -> None:
    """K4 at the 1.1B's prefill shapes (one sequence, end-padded chunks of
    the engine's buckets T=128/256/512 with 100/200/300 real rows, H=32,
    Hkv=4, D=64), then head_dim 128 (8B-class GQA: H=32, Hkv=8) and 256
    (H=8, Hkv=4)."""
    for T, n, H, Hkv, D in ((128, 100, 32, 4, 64), (256, 200, 32, 4, 64),
                            (512, 300, 32, 4, 64), (256, 230, 32, 8, 128),
                            (256, 230, 8, 4, 256)):
        q, k, v = (_bf16(rng, (1, T, h, D)) for h in (H, Hkv, Hkv))
        pos = torch.tensor([list(range(n)) + [-1] * (T - n)],
                           dtype=torch.int32, device=DEV)
        scale = D ** -0.5
        out = flash_prefill.flash_prefill_attention(q, k, v, pos, scale)
        ref = flash_prefill.flash_prefill_plain(q, k, v, pos, scale)
        # W = sum_j p_j |v_j| / l per output element: the softmax over |V|
        w = flash_prefill.flash_prefill_plain(q, k, v.abs(), pos,
                                              scale).float()
        torch.cuda.synchronize()
        what = f"B=1 T={T} real={n} H={H} Hkv={Hkv} D={D}"
        # each p is rounded to bf16 (2^-8 relative) against another running
        # max on each side: 2^-7 * W_d, 5% more for f32 sums and exp in
        # another order; plus the two bf16 roundings of the output (2^-8
        # |ref|). Checked element by element.
        tol_el = 2 ** -7 * 1.05 * w + 2 ** -8 * ref.float().abs()
        diff = (out.float() - ref.float()).abs()
        worst = (diff / tol_el.clamp_min(1e-30)).max().item()
        _check(worst <= 1.0, f"K4 {what}: max |err| / elementwise tol {worst}")
        err = diff.max().item()
        tol = tol_el.flatten()[diff.argmax()].item()
        print(f"K4 {what}: worst |err| / (2^-7 * 1.05 * W + 2^-8 |ref|) "
              f"{worst:.3g}", flush=True)
        # library: causal SDPA (GQA) over the real rows only
        qs, ks, vs = (t[:, :n].transpose(1, 2) for t in (q, k, v))
        m = T - n
        pairs = n * (n + 1) // 2 + m * (m + 1) // 2  # visible (i, j) pairs
        _record("K4", what, err, tol,
                lambda: flash_prefill.flash_prefill_attention(
                    q, k, v, pos, scale),
                lambda: flash_prefill.flash_prefill_plain(q, k, v, pos, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, scale=scale, enable_gqa=True),
                _nbytes(q, k, v, pos) + _nbytes(q), 4 * H * D * pairs,
                dev=True)


QUANT_POSITIONS = (0, 1, 63, 64, 700, 2047, -1, 256)


def _quantize_history(kc0, Hkv: int, bits: int):
    """(B, S, Hkv*D) bf16 -> codes (B, S, Hkv*D or /2), scales (B, S, Hkv)
    and the bf16 values they dequantize to (B, S, Hkv*D)."""
    B, S, KD = kc0.shape
    x = kc0.view(B, S, Hkv, KD // Hkv)
    if bits == 4:
        codes, sc = paged._quantize_q4(x)
        deq = paged._dequantize_q4(codes, sc)
    else:
        codes, sc = _q8(x)
        deq = _dequant(codes, sc)
    return codes.reshape(B, S, -1), sc, deq.reshape(B, S, KD)


def phase_quant_decode(rng) -> None:
    """K6 over the Q8 slot cache (B=8, S=2048) and K9 / K10 over the Q8 /
    Q4 pools (B=8, P=64, MP=32 pages handed out in a shuffled order), the
    1.1B's batched decode shape (H=32, Hkv=4, D=64), at positions
    QUANT_POSITIONS (pos 0, page boundaries, the last row, a dead slot),
    flat scores, then peaked ones (see _peak); then K9 / K10 at P=128
    (MP=16), the page size where the JAX package runs K11 over column
    pools; then each of the three peaked at each of HEAD_SHAPES."""
    for kid in ("K6", "K9", "K10"):
        for peaked in (False, True):
            _quant_case(rng, kid, 8, 32, 4, 64, 64, 32, QUANT_POSITIONS,
                        peaked)
    for kid in ("K9", "K10"):
        _quant_case(rng, kid, 8, 32, 4, 64, 128, 16, QUANT_POSITIONS, True)
    for kid in ("K6", "K9", "K10"):
        for H, Hkv, D in HEAD_SHAPES:
            _quant_case(rng, kid, 8, H, Hkv, D, 64, 32, QUANT_POSITIONS, True)
            torch.cuda.empty_cache()
    # the repaired head_dims: K6 at each, K9 / K10 at D = 20 (K10's 10
    # bytes a head: two-byte pieces by plain loads) and the streamed ones
    for kid, shapes in (("K6", REPAIRED_SHAPES),
                        ("K9", REPAIRED_SHAPES[:1] + STREAMED_SHAPES),
                        ("K10", REPAIRED_SHAPES[:1] + STREAMED_SHAPES)):
        for H, Hkv, D in shapes:
            _quant_case(rng, kid, 8, H, Hkv, D, 64, 32, QUANT_POSITIONS, True)


def _quant_case(rng, kid, B, H, Hkv, D, P, MP, positions, peaked) -> None:
    S, KD, NP = MP * P, Hkv * D, B * MP
    scale = D ** -0.5
    bits = 4 if kid == "K10" else 8
    kc0, vc0 = _bf16(rng, (B, S, KD), 0.5), _bf16(rng, (B, S, KD), 0.5)
    q, kn, vn = _bf16(rng, (B, H, D)), _bf16(rng, (B, Hkv, D)), \
        _bf16(rng, (B, Hkv, D))
    if peaked:
        _peak(rng, q, kc0, positions, H // Hkv)
    kq, ks, kd = _quantize_history(kc0, Hkv, bits)
    vq, vs, vd = _quantize_history(vc0, Hkv, bits)
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    if kid == "K6":
        cache0 = (kq, vq, ks, vs)
        fn, plain = (flash_decode.decode_attention_batched_q8,
                     flash_decode.decode_attention_batched_q8_plain)
        extra, pargs = (pos,), ()
        rows = torch.arange(B * S, device=DEV).view(B, S)
    else:
        # scatter each sequence's history into the pool through a shuffled
        # page table
        table = torch.from_numpy(rng.permutation(NP).reshape(B, MP).astype(
            np.int32)).to(DEV)
        rows = flash_decode._page_rows(table, P, NP)  # (B, S) pool rows
        cache0 = []
        for t in (kq, vq, ks, vs):
            pool = torch.zeros((NP * P, t.shape[-1]), dtype=t.dtype,
                               device=DEV)
            pool[rows.reshape(-1)] = t.reshape(B * S, -1)
            cache0.append(pool)
        fn = (flash_decode.decode_attention_paged_q4 if bits == 4
              else flash_decode.decode_attention_paged_q8)
        plain = flash_decode.decode_attention_paged_quant_plain
        extra, pargs = (table, pos), (bits,)
    flat = [c.reshape(-1, c.shape[-1]) for c in cache0]
    args = (H, Hkv) + ((P,) if kid != "K6" else ()) + (scale,)
    ck = [c.clone() for c in cache0]
    out = fn(q, kn, vn, *ck, *extra, *args)[0]
    cr = [c.clone() for c in cache0]
    ref = plain(q, kn, vn, *cr, *extra, *args, 0.0, *pargs)
    # W = sum_s p_s |v_s| / l over the dequantized history and new row (the
    # softmax over |V|, in K6's value-side arithmetic)
    _, _, kdq = flash_decode._quantize_row(kn, bits)
    _, _, vdq = flash_decode._quantize_row(vn, bits)
    hist = torch.tensor([min(p, S) if p >= 0 else S for p in positions],
                        device=DEV)
    w = flash_decode._attend_plain(q, kdq, vdq.abs(), kd, vd.abs(), hist, H,
                                   Hkv, scale, 0.0)
    torch.cuda.synchronize()
    what = (f"B={B} H={H} Hkv={Hkv} D={D}"
            + (f" S={S}" if kid == "K6" else f" P={P} MP={MP}")
            + f" pos={positions}" + (" peaked" if peaked else ""))
    _check(all(torch.equal(a, b) for a, b in zip(ck, cr)),
           f"{kid} {what}: kernel and plain caches differ")
    # only the rows at pos changed
    changed = torch.zeros(flat[0].shape[0], dtype=torch.bool, device=DEV)
    for a, b in zip(ck, flat):
        changed |= (a.reshape(b.shape) != b).any(dim=1)
    want = {int(rows[b, p]) for b, p in enumerate(positions) if 0 <= p < S}
    _check(set(changed.nonzero().flatten().tolist()) <= want,
           f"{kid} {what}: rows other than those at pos changed")
    # K5's per-element bound (see _flash_decode_case)
    tol_el = 2 ** -7 * 1.05 * w
    live = [b for b, p in enumerate(positions) if p >= 0]
    diff = (out - ref).abs()[live]
    worst = (diff / tol_el[live].clamp_min(1e-30)).max().item()
    _check(worst <= 1.0, f"{kid} {what}: max |err| / elementwise tol {worst}")
    err = diff.max().item()
    tol = tol_el[live].flatten()[diff.argmax()].item()
    print(f"{kid} {what}: worst |err| / (2^-7 * 1.05 * W) {worst:.3g}; "
          f"codes and scales equal the plain version's", flush=True)
    # library: SDPA over the dequantized history laid out contiguously plus
    # this step's dequantized row, masked to the live prefix (dead: all)
    ql = q.view(B, H, 1, D)
    kl = torch.cat([kd, kdq.reshape(B, 1, KD)], 1).view(
        B, S + 1, Hkv, D).transpose(1, 2)
    vl = torch.cat([vd, vdq.reshape(B, 1, KD)], 1).view(
        B, S + 1, Hkv, D).transpose(1, 2)
    cols = torch.arange(S + 1, device=DEV)
    mask = torch.stack([(cols < p) | (cols == S) if p >= 0 else cols >= 0
                        for p in positions])[:, None, None, :]
    hist_rows = sum(min(p, S) if p >= 0 else S for p in positions)
    n_written = sum(0 <= p < S for p in positions)
    row_bytes = sum(c.shape[-1] * c.element_size() for c in flat)  # k+v+sc
    _record(kid, what, err, tol,
            lambda: fn(q, kn, vn, *ck, *extra, *args),
            lambda: plain(q, kn, vn, *cr, *extra, *args, 0.0, *pargs),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, scale=scale, enable_gqa=True),
            hist_rows * row_bytes + _nbytes(q, kn, vn, *extra)
            + B * H * D * 4 + n_written * row_bytes, dev=True)


# ---------------------------------------------------------------------------
# 2b. the scan decode path's kernels: K17a / K17b (layer-stacked matvecs),
# K17c (pooled-row flash decode), K16, and K5 over an f32 cache
# ---------------------------------------------------------------------------

# layers of the stacked matvec cases (li 0 and L-1 held: two show a
# stride or offset fault as four do, at half the host draw)
STACKED_L = 2
STACKED_SHAPES = (("wqkv", (2560, 2048)), ("wo", (2048, 2048)),
                  ("w_gateup", (11264, 2048)), ("w_down", (2048, 5632)))


def _stack_rows(qt, n_layers: int):
    """A QTensor of n_layers * out_f rows as a layer-stacked one: each
    field (n_layers * out_f, ...) viewed as (n_layers, out_f, ...)."""
    out_f = qt.shape[0] // n_layers
    return QTensor(kind=qt.kind, shape=(out_f, qt.shape[1]),
                   data={n: a.view(n_layers, out_f, *a.shape[1:])
                         for n, a in qt.data.items()})


def _per_layer_kernel(kind: str):
    """The per-layer T=1 kernel whose body K17a / K17b runs for `kind`."""
    if kind in ("q4_k", "q5_k"):
        return qm.q4k_matvec
    if kind == "q6_k":
        return qm.q6k_matvec
    if kind == "q8_0":
        return qm.q8_0_matvec
    if kind in ("q2_k", "q3_k"):
        return qm.q23k_matvec
    return lambda x, qt, i8: qm.iq_matvec(x, qt)


# (counter, kind, int8 activations, name suffix, with the output head)
STACKED_BODIES = (
    ("K17a", "q4_k", True, "", True), ("K17a", "q4_k", False, " bf16 x",
                                        False),
    ("K17a.q5_k", "q5_k", True, "", False),
    ("K17b", "q6_k", True, "", False), ("K17b", "q6_k", False, " bf16 x",
                                         False),
    ("K17b.q8_0", "q8_0", True, "", True),
    ("K17b.q8_0_bf16", "q8_0", False, "", False),
    ("K17b.q2_k", "q2_k", True, "", False),
    ("K17b.q2_k", "q2_k", False, " bf16 x", False),
    ("K17b.q3_k", "q3_k", True, "", False),
    ("K17b.q3_k", "q3_k", False, " bf16 x", False),
    *((f"K17b.{k}", k, True, "", False)
      for k in ("iq2p", "iq3px", "iq3ps", "iq1p")))


def phase_stacked(rng) -> None:
    """K17a / K17b: every body on L=STACKED_L stacked layers at the 1.1B's
    four layer shapes (and the output head's for the two kinds the scan
    path serves, q4_k and q8_0): at li = 0 and li = L - 1, bit for bit the
    per-layer kernel (K1, K2, K12) on that layer (the same body, so any
    difference is a stride or offset fault), and at li = L - 1 within the
    per-layer kernel's tolerance of its plain version, timed beside cuBLAS
    over the layer's dequantized bf16 weight. Then K17c, K5 over an f32
    cache and K16 (see their cases)."""
    ids = torch.arange(STACKED_L, dtype=torch.int32, device=DEV)
    for kid, kind, i8, tag, head in STACKED_BODIES:
        shapes = STACKED_SHAPES + ((("output", (32000, 2048)),) if head
                                   else ())
        stacked_fn = (qm.q4k_matvec_stacked if kind in ("q4_k", "q5_k")
                      else qm.matvec_stacked)
        plain_fn = (qm.q4k_matvec_stacked_plain if kind in ("q4_k", "q5_k")
                    else qm.matvec_stacked_plain)
        layer_fn = _per_layer_kernel(kind)
        for name, (out_f, in_f) in shapes:
            st = _stack_rows(_MAKERS[kind](rng, STACKED_L * out_f, in_f,
                                           DEV), STACKED_L)
            x = torch.from_numpy(rng.standard_normal(in_f).astype(
                np.float32)).to(DEV).bfloat16()
            for li in (0, STACKED_L - 1):
                y = stacked_fn(x, st, ids[li:li + 1], i8)
                want = layer_fn(x, qm.layer_of(st, li), i8)
                torch.cuda.synchronize()
                _check(torch.equal(y, want),
                       f"{kid} {name}{tag} li={li}: differs from the "
                       "per-layer kernel on that layer")
            li = STACKED_L - 1
            idx = ids[li:li + 1]
            ref = plain_fn(x, st, li, i8)
            err = (y.float() - ref.float()).abs().max().item()
            # the per-layer kernel's tolerance (phase_matvec): q8_0 repeats
            # its plain version bit for bit, the others one bf16 step
            tol = (0.0 if kind == "q8_0"
                   else 2 ** -7 * ref.float().abs().max().item())
            layer = qm.layer_of(st, li)
            w = dequant(layer)
            xr = x.view(1, in_f)
            _record(kid, f"{name} {out_f}x{in_f} L={STACKED_L} li={li}{tag}",
                    err, tol, lambda: stacked_fn(x, st, idx, i8),
                    lambda: plain_fn(x, st, li, i8),
                    lambda: torch.matmul(xr, w.t()),
                    _wbytes(layer) + _nbytes(x) + out_f * 2, dev=True)
            if kid.startswith("K17a"):
                _q4k_class(kid, name, 1, i8)
            elif kid in ROWMV_KIDS:
                _rowmv_class(kid, name, i8)
            del w, st
    torch.cuda.empty_cache()
    # K17c: TinyLlama's heads and an 8B-class head_dim 128, one and eight
    # sequences over a 22-layer pool; positions mixed, one dead slot
    for B, H, Hkv, D, positions, dt in (
            (1, 32, 4, 64, (700,), torch.bfloat16),
            (8, 32, 4, 64, (0, 1, 63, 256, 700, 1500, 2047, -1),
             torch.bfloat16),
            (8, 32, 4, 64, (0, 1, 63, 256, 700, 1500, 2047, -1),
             torch.float32),
            (8, 32, 8, 128, (5, 300, 1024, 2047, -1, 64, 900, 1999),
             torch.bfloat16),
            *((2, *shape, (700, 2047), torch.bfloat16)
              for shape in STREAMED_SHAPES)):
        _rows_case(rng, B, H, Hkv, D, positions, dt)
        torch.cuda.empty_cache()
    # K5 over the f32 cache kind (the repair that K17c shares)
    _flash_decode_case(rng, 1, 2048, 32, 4, 64, (700,), True, torch.float32)
    _flash_decode_case(rng, 2, 4096, 32, 8, 128, (3000, -1), True,
                       torch.float32)
    for S, pos, softcap in ((256, 0, 0.0), (256, 37, 0.0), (256, 255, 0.0),
                            (2048, 0, 0.0), (2048, 37, 0.0),
                            (2048, 2047, 0.0), (2048, 700, 30.0)):
        _k16_case(rng, S, 32, 4, 64, pos, softcap)
    for shape in STREAMED_SHAPES:
        _k16_case(rng, 2048, *shape, 700, 0.0)


POOL_LAYERS = 22  # the 1.1B's depth: K17c's pool holds every layer
POOL_S = 2048  # rows per sequence of K17c's pool (the served context)


def _rows_case(rng, B, H, Hkv, D, positions, dtype) -> None:
    """K17c over a (22 B, 2048, Hkv D) pool at li = 0 and 21: bit for bit
    K5 on the window's views (output and written rows), every other row of
    the pool unchanged; at li = 21 within K5's tolerance of its plain
    version (2^-7 * 1.05 * W element by element)."""
    S, L, KD = POOL_S, POOL_LAYERS, Hkv * D
    scale = D ** -0.5

    def t(shape, s=1.0, dt=torch.bfloat16):
        return _normal(rng, shape, s, dt)

    kp0, vp0 = t((L * B, S, KD), 0.5, dtype), t((L * B, S, KD), 0.5, dtype)
    q, kn, vn = t((B, H, D)), t((B, Hkv, D)), t((B, Hkv, D))
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    ids = torch.arange(L, dtype=torch.int32, device=DEV)
    what = (f"B={B} S={S} H={H} Hkv={Hkv} D={D} L={L} pos={positions}"
            + (" f32 pool" if dtype == torch.float32 else ""))
    for li in (0, L - 1):
        win = slice(li * B, li * B + B)
        kp, vp = kp0.clone(), vp0.clone()
        out, _, _ = flash_decode.decode_attention_rows(
            q, kn, vn, kp, vp, pos, ids[li:li + 1], H, Hkv, scale)
        kr, vr = kp0.clone(), vp0.clone()
        ref, _, _ = flash_decode.decode_attention_batched(
            q, kn, vn, kr[win], vr[win], pos, H, Hkv, scale)
        torch.cuda.synchronize()
        _check(torch.equal(out, ref),
               f"K17c {what} li={li}: output differs from K5 on the window")
        _check(torch.equal(kp, kr) and torch.equal(vp, vr),
               f"K17c {what} li={li}: the pool differs from K5's writes on "
               "the window views (a row outside the window moved)")
        rest = torch.ones(L * B, dtype=torch.bool, device=DEV)
        rest[win] = False
        _check(torch.equal(kp[rest], kp0[rest])
               and torch.equal(vp[rest], vp0[rest]),
               f"K17c {what} li={li}: another layer's rows changed")
    pl_k, pl_v = kp0.clone(), vp0.clone()
    want = flash_decode.decode_attention_rows_plain(
        q, kn, vn, pl_k, pl_v, pos, li, H, Hkv, scale)
    w = flash_decode.decode_attention_rows_plain(
        q, kn, vn.abs(), kp0.clone(), vp0.abs(), pos, li, H, Hkv, scale)
    torch.cuda.synchronize()
    _check(torch.equal(kp, pl_k) and torch.equal(vp, pl_v),
           f"K17c {what}: kernel and plain pools differ")
    live = torch.tensor([p >= 0 for p in positions], device=DEV)
    diff = (out - want).abs()[live]
    tol_el = (2 ** -7 * 1.05 * w)[live]
    worst = (diff / tol_el.clamp_min(1e-30)).max().item()
    _check(worst <= 1.0, f"K17c {what}: max |err| / elementwise tol {worst}")
    print(f"K17c {what}: bit-equal to K5 on the window at li 0 and {L - 1}; "
          f"worst |err| / (2^-7 * 1.05 * W) {worst:.3g}", flush=True)
    # library: SDPA over each live sequence's prefix (history + this row)
    base = (L - 1) * B
    n = [min(p, S) + 1 if p >= 0 else 0 for p in positions]
    cols = torch.arange(S, device=DEV)
    mask = torch.stack([cols < m for m in n])[:, None, None, :]
    kq = kp[base:base + B].view(B, S, Hkv, D).transpose(1, 2)
    vq = vp[base:base + B].view(B, S, Hkv, D).transpose(1, 2)
    ql = q.view(B, H, 1, D).to(dtype)
    idx = ids[L - 1:L]
    el = kp0.element_size()
    hist_rows = sum(min(p, S) if p >= 0 else S for p in positions)
    n_written = sum(0 <= p < S for p in positions)
    _record("K17c", what, diff.max().item(),
            tol_el.flatten()[diff.argmax()].item(),
            lambda: flash_decode.decode_attention_rows(
                q, kn, vn, kp, vp, pos, idx, H, Hkv, scale),
            lambda: flash_decode.decode_attention_rows_plain(
                q, kn, vn, pl_k, pl_v, pos, L - 1, H, Hkv, scale),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                ql, kq, vq, attn_mask=mask, scale=scale, enable_gqa=True),
            2 * hist_rows * KD * el + _nbytes(q, kn, vn, pos) + B * H * D * 4
            + 2 * n_written * KD * el, dev=True)


def _k16_case(rng, S, H, Hkv, D, pos, softcap) -> None:
    """K16 against its plain version: rows <= pos of one sequence's bf16
    cache, q in f32, within 2^-7 * 1.05 * W element by element (K5's
    bound: p rounded to bf16 against another running max on each side)."""
    scale = D ** -0.5

    def t(shape, s=1.0):
        return _normal(rng, shape, s, torch.float32)

    q = t((H, D), 3.0 if softcap else 1.0)
    k, v = t((S, Hkv, D), 0.5).bfloat16(), t((S, Hkv, D), 0.5).bfloat16()
    p = torch.tensor([pos], dtype=torch.int32, device=DEV)
    out = flash_decode.decode_attention(q, k, v, p, H, scale, softcap)
    ref = flash_decode.decode_attention_plain(q, k, v, p, H, scale, softcap)
    w = flash_decode.decode_attention_plain(q, k, v.abs(), p, H, scale,
                                            softcap)
    torch.cuda.synchronize()
    _check(out.shape == (H, D) and out.dtype == torch.float32,
           f"K16: out {out.shape} {out.dtype}")
    diff = (out - ref).abs()
    tol_el = 2 ** -7 * 1.05 * w
    worst = (diff / tol_el.clamp_min(1e-30)).max().item()
    what = (f"S={S} H={H} Hkv={Hkv} D={D} pos={pos}"
            + (f" softcap={softcap}" if softcap else ""))
    _check(worst <= 1.0, f"K16 {what}: max |err| / elementwise tol {worst}")
    n = min(pos, S - 1) + 1
    ql = q.bfloat16().view(1, H, 1, D)
    kq = k[:n].view(1, n, Hkv, D).transpose(1, 2)
    vq = v[:n].view(1, n, Hkv, D).transpose(1, 2)
    # SDPA has no softcap: a yardstick of the same reads, not of the cap
    _record("K16", what, diff.max().item(),
            tol_el.flatten()[diff.argmax()].item(),
            lambda: flash_decode.decode_attention(q, k, v, p, H, scale,
                                                  softcap),
            lambda: flash_decode.decode_attention_plain(q, k, v, p, H, scale,
                                                        softcap),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                ql, kq, vq, scale=scale, enable_gqa=True),
            2 * n * Hkv * D * 2 + _nbytes(q, p) + H * D * 4, dev=True)


# ---------------------------------------------------------------------------
# 3. end to end: synthetic TinyLlama-1.1B q4_k served through Engine
# ---------------------------------------------------------------------------

def phase_end_to_end(card: str) -> tuple[dict, float]:
    """Returns (launch counts, decode tokens/s of the first request)."""
    model = synthetic_model(TINYLLAMA_1_1B, "q4_k", seed=0, device=DEV)
    eng = Engine(model, max_context=2048, device=DEV)
    _check(eng.use_flash_prefill, "flash prefill (K4) is off on the card")
    gp = GenParams(max_length=DEPTH, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    rng = np.random.default_rng(1)
    prompt = [1] + rng.integers(3, 32000, size=299).tolist()
    # warm-up; the repeat takes the fast-forward path, whose first call
    # builds the native helper library (native/, make) outside the timings
    for _ in range(2):
        eng.generate(prompt[:40], GenParams(max_length=40, bypass_eos=True,
                                            sampler=gp.sampler))
    eng.reset_context()

    _build.launches.clear()
    r1 = eng.generate(prompt, gp)
    t1 = eng.last_timings
    r2 = eng.generate(prompt, gp)
    t2 = eng.last_timings
    # history scrolled: the gap [10, 60) drops out of the middle
    shifted = prompt[:10] + prompt[60:] + r2.tokens[:8]
    r3 = eng.generate(shifted, GenParams(max_length=16, bypass_eos=True,
                                         sampler=gp.sampler))
    t3 = eng.last_timings
    counts = dict(_build.launches)

    _check(len(r1.tokens) == DEPTH and r2.tokens == r1.tokens,
           "greedy decode is not repeatable")
    # fast-forward: the repeat re-evaluates only the last prompt token
    _check(t1.prompt_tokens == 300 and t2.prompt_tokens == 1, (t1, t2))
    _check(t3.prompt_tokens <= 9 and len(r3.tokens) == 16,
           f"context shift did not reuse the cache: {t3}")
    for k in ("K1", "K3", "K4", "K5"):
        _check(counts.get(k, 0) > 0, f"{k} did not run on the main path")
    # one chunk from position 0 (the 300-token prompt): one K4 per layer
    _check(counts["K4"] == TINYLLAMA_1_1B.n_layers,
           f"K4 ran {counts['K4']} times for one chunk from position 0")
    with torch.inference_mode():
        logits = eng._eval_chunk([5], len(eng.context_tokens))
    _check(logits.shape == (32000,) and bool(torch.isfinite(logits).all()),
           "logits are not finite (32000,)")
    # the same prompt with flash prefill off (the plain attention over the
    # whole cache) and on again, in turns: the same tokens, near-ties apart
    pre = {True: [t1.prompt_time], False: []}
    for flash in (False, True, False):
        eng.use_flash_prefill = flash
        eng.reset_context()
        r = eng.generate(prompt, gp)
        pre[flash].append(eng.last_timings.prompt_time)
        _same_or_near_tie(eng, prompt, r.tokens, r1.tokens,
                          f"flash prefill {'on' if flash else 'off'}")
    eng.use_flash_prefill = True
    print(f"end to end (synthetic TinyLlama-1.1B q4_k, {card}): prefill "
          f"{t1.prompt_tokens} tokens {t1.prompt_tps:.1f} tok/s "
          f"({t1.prompt_time * 1e3:.1f} ms), decode {t1.gen_tokens} tokens "
          f"{t1.gen_tps:.1f} tok/s ({t1.gen_time * 1e3:.1f} ms); "
          f"fast-forward repeat: {t2.prompt_tokens} prompt token "
          f"({t2.prompt_time * 1e3:.2f} ms), decode {t2.gen_tps:.1f} tok/s; "
          f"context shift re-evaluated {t3.prompt_tokens} tokens; "
          f"launches {counts}", flush=True)
    print("prefill of the 300-token prompt, ms, in turns: flash prefill "
          f"(K4) {[round(t * 1e3, 3) for t in pre[True]]}, plain attention "
          f"{[round(t * 1e3, 3) for t in pre[False]]}; the same tokens",
          flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return counts, t1.gen_tps


def phase_quant_single(card: str, bf16_tps: float) -> dict:
    """The synthetic 1.1B single-stream with `quantkv=1`: the 300-token
    prompt (K4 writes the Q8 cache) and DEPTH greedy tokens through K6."""
    model = synthetic_model(TINYLLAMA_1_1B, "q4_k", seed=0, device=DEV)
    eng = Engine(model, max_context=2048, device=DEV, quantkv=1)
    gp = GenParams(max_length=DEPTH, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    prompt = [1] + np.random.default_rng(1).integers(
        3, 32000, size=299).tolist()
    eng.generate(prompt[:40], GenParams(max_length=40, bypass_eos=True,
                                        sampler=gp.sampler))
    eng.reset_context()
    _build.launches.clear()
    r1 = eng.generate(prompt, gp)
    t1 = eng.last_timings
    r2 = eng.generate(prompt, gp)
    counts = dict(_build.launches)
    _check(len(r1.tokens) == DEPTH and r2.tokens == r1.tokens
           and all(0 <= t < 32000 for t in r1.tokens),
           "Q8 greedy decode is not repeatable")
    _check(eng.last_timings.prompt_tokens == 1, "Q8: no fast-forward")
    _check(counts.get("K6", 0) > 0 and counts.get("K5", 0) == 0,
           f"K6 did not take K5's place under quantkv=1: {counts}")
    _check(counts.get("K4", 0) == TINYLLAMA_1_1B.n_layers,
           f"K4 did not prefill the Q8 cache: {counts}")
    with torch.inference_mode():
        logits = eng._eval_chunk([5], len(eng.context_tokens))
    _check(bool(torch.isfinite(logits).all()), "Q8 logits are not finite")
    print(f"end to end, --quantkv 1 ({card}): prefill {t1.prompt_tokens} "
          f"tokens {t1.prompt_time * 1e3:.1f} ms, decode {t1.gen_tokens} "
          f"tokens {t1.gen_tps:.1f} tok/s (bf16 cache in this run: "
          f"{bf16_tps:.1f} tok/s); launches {counts}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return counts


# the plain versions of K5 / K6 with the kernels' signatures, patched in to
# hold a served path's tokens to them
def _k5_plain(q, kn, vn, kc, vc, pos, H, Hkv, scale, softcap=0.0):
    return flash_decode.decode_attention_batched_plain(
        q, kn, vn, kc, vc, pos, H, Hkv, scale, softcap), kc, vc


def _k6_plain(q, kn, vn, kc, vc, ks, vs, pos, H, Hkv, scale, softcap=0.0):
    return flash_decode.decode_attention_batched_q8_plain(
        q, kn, vn, kc, vc, ks, vs, pos, H, Hkv, scale, softcap), \
        kc, vc, ks, vs


# Phi-3-mini's published widths (microsoft/Phi-3-mini-4k-instruct,
# config.json: hidden 3072, 32 attention heads of 96 over 32 kv heads, ffn
# 8192, vocab 32064), depth cut from 32 layers to PHI3_LAYERS to keep the
# script within its time; synthetic q4_k weights from a seed
PHI3_LAYERS = 8
PHI3_MINI = dataclasses.replace(
    TINYLLAMA_1_1B, name="phi-3-mini-shaped-synthetic", vocab_size=32064,
    hidden_size=3072, n_layers=PHI3_LAYERS, n_heads=32, n_kv_heads=32,
    head_dim=96, intermediate_size=8192, max_position_embeddings=4096,
    rope_dim=96)
PHI3_DEPTH = 16  # greedy tokens


def phase_phi3_decode(card: str) -> dict:
    """A head_dim-96 model on the card: the synthetic Phi-3-mini-shaped q4_k
    model, a 300-token prompt (prefill through the plain attention: K4 is
    not built for head_dim 96, and the JAX engine leaves flash prefill off
    there too), then PHI3_DEPTH greedy tokens, every decode step through K5
    (one per layer); the same tokens with K5's plain version in its place
    (near-ties apart)."""
    model = synthetic_model(PHI3_MINI, "q4_k", seed=0, device=DEV)
    eng = Engine(model, max_context=2048, device=DEV)
    _check(not eng.use_flash_prefill, "flash prefill on at head_dim 96")
    gp = GenParams(max_length=PHI3_DEPTH, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    prompt = [1] + np.random.default_rng(3).integers(
        3, PHI3_MINI.vocab_size, size=299).tolist()
    eng.generate(prompt[:40], GenParams(max_length=8, bypass_eos=True,
                                        sampler=gp.sampler))
    eng.reset_context()
    _build.launches.clear()
    r1 = eng.generate(prompt, gp)
    t1 = eng.last_timings
    counts = dict(_build.launches)
    _check(len(r1.tokens) == PHI3_DEPTH
           and all(0 <= t < PHI3_MINI.vocab_size for t in r1.tokens),
           f"Phi-3-mini shape: tokens {r1.tokens}")
    steps = counts.get("K5", 0) // PHI3_MINI.n_layers
    _check(counts.get("K5", 0) == PHI3_MINI.n_layers * steps
           and steps >= PHI3_DEPTH - 1 and counts.get("K4", 0) == 0,
           f"Phi-3-mini shape: K5 did not serve every decode step: {counts}")

    eng.reset_context()
    with mock.patch.object(flash_decode, "decode_attention_batched",
                           _k5_plain):
        r2 = eng.generate(prompt, gp)
    _same_or_near_tie(eng, prompt, r1.tokens, r2.tokens,
                      "Phi-3-mini shape, K5 against its plain version")
    c = PHI3_MINI
    print(f"Phi-3-mini shape (hidden {c.hidden_size}, {c.n_heads}/"
          f"{c.n_kv_heads} heads of {c.head_dim}, {c.n_layers} layers, q4_k, "
          f"{card}): prefill {t1.prompt_tokens} tokens "
          f"{t1.prompt_time * 1e3:.1f} ms, decode {t1.gen_tokens} tokens "
          f"{t1.gen_tps:.1f} tok/s; {steps} decode steps (the engine's "
          f"greedy chunks) through K5, {c.n_layers} a step; the same tokens "
          f"with K5's plain version; launches {counts}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return counts


# Gemma-2-9B's published widths (google/gemma-2-9b config.json: vocab
# 256000, hidden 3584, ffn 14336, 16 heads of 256 over 8 kv heads, a
# sliding window of 4096 on every other layer, softcaps 50 / 30, tanh gelu,
# context 8192, tied embeddings), as the GGUF keys a converted file
# carries, read by the port's config_from_metadata; depth cut from 42
# layers to GEMMA2_LAYERS (4 local, 4 global) to keep the script within
# its time; synthetic q4_k weights from a seed
GEMMA2_9B_MD = {
    "general.architecture": "gemma2", "gemma2.vocab_size": 256000,
    "gemma2.embedding_length": 3584, "gemma2.block_count": 42,
    "gemma2.feed_forward_length": 14336, "gemma2.context_length": 8192,
    "gemma2.attention.head_count": 16, "gemma2.attention.head_count_kv": 8,
    "gemma2.attention.key_length": 256, "gemma2.attention.value_length": 256,
    "gemma2.attention.layer_norm_rms_epsilon": 1e-6,
    "gemma2.attention.sliding_window": 4096,
    "gemma2.attn_logit_softcapping": 50.0,
    "gemma2.final_logit_softcapping": 30.0, "gemma2.rope.freq_base": 10000.0}
GEMMA2_LAYERS = 8
GEMMA2_PROMPT = 4400  # so that every decode position passes the window
# Phi-2's published widths (microsoft/phi-2 config.json: vocab 51200,
# hidden 2560, ffn 10240 non-gated gelu, 32 heads of 80 over 32 kv heads,
# rotary on 32 of 80 dims, layer norms with biases, every projection and
# the head biased, parallel residual, 32 layers), full depth
PHI2_MD = {
    "general.architecture": "phi2", "phi2.vocab_size": 51200,
    "phi2.embedding_length": 2560, "phi2.block_count": 32,
    "phi2.feed_forward_length": 10240, "phi2.context_length": 2048,
    "phi2.attention.head_count": 32, "phi2.attention.head_count_kv": 32,
    "phi2.attention.layer_norm_epsilon": 1e-5,
    "phi2.rope.dimension_count": 32, "phi2.rope.freq_base": 10000.0}
ARCH_DEPTH = 16  # greedy tokens of the two architecture phases


def _arch_decode(model, what: str, prompt: list[int], max_context: int,
                 quantkv: int = 0):
    """One model single-stream on the card: the prompt, then ARCH_DEPTH
    greedy tokens; every decode step launches the T=1 attention kernel
    (K5, K6 under quantkv=1) once per global layer and K4 never (a softcap
    or a head_dim K4 is not built for); then the same prompt again
    (fast-forward: the last prompt token re-evaluated) with the kernel's
    plain version in its place gives the same tokens (near-ties apart).
    Returns (engine, reply, timings, launch counts, decode steps)."""
    cfg = model.cfg
    kid, name, plain = (("K6", "decode_attention_batched_q8", _k6_plain)
                        if quantkv else
                        ("K5", "decode_attention_batched", _k5_plain))
    eng = Engine(model, max_context=max_context, device=DEV, quantkv=quantkv)
    gp = GenParams(max_length=ARCH_DEPTH, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    eng.generate(prompt[:40], GenParams(max_length=4, bypass_eos=True,
                                        sampler=gp.sampler))
    eng.reset_context()
    _build.launches.clear()
    with _StepLaunches() as rec:
        r1 = eng.generate(prompt, gp)
    t1 = eng.last_timings
    counts = dict(_build.launches)
    n_global = sum(not llama._is_local(cfg, li) for li in range(cfg.n_layers))
    steps = _check_steps(rec, 1, {kid: n_global, "K4": 0}, what)
    _check(len(r1.tokens) == ARCH_DEPTH
           and all(0 <= t < cfg.vocab_size for t in r1.tokens)
           and counts.get("K4", 0) == 0, f"{what}: {r1.tokens} {counts}")
    with mock.patch.object(flash_decode, name, plain):
        r2 = eng.generate(prompt, gp)
    _check(eng.last_timings.prompt_tokens == 1, f"{what}: no fast-forward")
    _same_or_near_tie(eng, prompt, r1.tokens, r2.tokens,
                      f"{what}, {kid} against its plain version")
    return eng, r1, t1, counts, steps


def phase_gemma2_decode(card: str) -> dict:
    """Gemma-2-9B's widths (8 of 42 layers) on the card: a GEMMA2_PROMPT-
    token prompt, so that every decode position lies past the 4096 window
    of the local layers, then ARCH_DEPTH greedy tokens: K5 on the 4 global
    layers of every step only (the local layers write the cache and run
    the plain attention under the window, as in JAX), K4 off (the
    softcap), the same tokens with K5's plain version; the same over the
    Q8 cache (K6); then one paged wave of 4 requests of 100-300 prompt
    tokens (K8 on the global layers, with the softcap), each getting its
    single-stream tokens."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(config_from_metadata(GEMMA2_9B_MD),
                              n_layers=GEMMA2_LAYERS)
    model = synthetic_model(cfg, "q4_k", seed=0, device=DEV)
    _check(model.params["output"] is model.params["tok_embd"],
           "Gemma-2: the head is not the tied embedding")
    made = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    prompt = [2] + rng.integers(3, cfg.vocab_size,
                                size=GEMMA2_PROMPT - 1).tolist()
    eng, r1, t1, counts, steps = _arch_decode(model, "Gemma-2", prompt, 8192)
    qeng, q1, qt1, qcounts, qsteps = _arch_decode(model, "Gemma-2 Q8",
                                                  prompt, 8192, quantkv=1)
    del qeng
    torch.cuda.empty_cache()
    for k, v in qcounts.items():
        counts[k] = counts.get(k, 0) + v

    # one paged wave: 4 requests at once, each against its single-stream
    # tokens from the bf16 engine
    gp = GenParams(max_length=ARCH_DEPTH, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    prompts = [[2] + rng.integers(3, cfg.vocab_size, size=n - 1).tolist()
               for n in (100, 170, 240, 300)]
    alone = []
    for p in prompts:
        eng.reset_context()
        alone.append(eng.generate(p, gp).tokens)
    beng = batch_engine.BatchedEngine(model, max_context=1024, n_slots=4,
                                      paged=True, device=DEV)
    try:
        _build.launches.clear()
        with _StepLaunches() as rec:
            res, secs = _serve_together(beng, prompts, [gp] * 4)
        wave = dict(_build.launches)
    finally:
        beng.shutdown()
    wsteps = _check_steps(rec, 4, {"K8": cfg.n_layers // 2, "K5": 0},
                          "Gemma-2 paged wave")
    for p, r, want in zip(prompts, res, alone):
        _same_or_near_tie(eng, p, r.tokens, want,
                          "Gemma-2 paged wave against single-stream")
    for k, v in wave.items():
        counts[k] = counts.get(k, 0) + v
    print(f"Gemma-2-9B widths ({cfg.n_layers} of 42 layers: 4 local with "
          f"window {cfg.sliding_window}, 4 global; {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"softcaps {cfg.attn_logit_softcap:g} / "
          f"{cfg.final_logit_softcap:g}, q4_k, tied dense head, {card}): "
          f"synthetic weights {made:.1f} s; prefill {t1.prompt_tokens} "
          f"tokens {t1.prompt_time * 1e3:.1f} ms (plain attention: the "
          f"softcap), decode {t1.gen_tokens} tokens {t1.gen_tps:.1f} tok/s, "
          f"{steps} steps of 4 K5; Q8 cache: prefill "
          f"{qt1.prompt_time * 1e3:.1f} ms, decode {qt1.gen_tps:.1f} tok/s, "
          f"{qsteps} steps of 4 K6; both the same tokens with the kernel's "
          f"plain version; paged wave of 4 ({secs:.2f} s, {wsteps} steps of "
          f"4 K8) equal to single-stream; launches {counts}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return counts


def phase_phi2_decode(card: str) -> dict:
    """Phi-2's widths at full depth (32 layers) on the card: a 300-token
    prompt (plain prefill attention: K4 is not built for head_dim 80),
    then ARCH_DEPTH greedy tokens, every step 32 K5, the same tokens with
    K5's plain version."""
    t0 = time.perf_counter()
    cfg = config_from_metadata(PHI2_MD)
    model = synthetic_model(cfg, "q4_k", seed=0, device=DEV)
    _check("output_bias" in model.params and "bq" in model.params["layers"][0]
           and "w_gateup" not in model.params["layers"][0],
           "Phi-2: synthetic params lack its biases or gateless FFN")
    made = time.perf_counter() - t0
    prompt = [1] + np.random.default_rng(6).integers(
        3, cfg.vocab_size, size=299).tolist()
    eng, r1, t1, counts, steps = _arch_decode(model, "Phi-2", prompt, 2048)
    print(f"Phi-2 widths ({cfg.n_layers} layers, hidden {cfg.hidden_size}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, rotary "
          f"{cfg.rope_dim}, parallel residual, non-gated gelu, biases, q4_k, "
          f"{card}): synthetic weights {made:.1f} s; prefill "
          f"{t1.prompt_tokens} tokens {t1.prompt_time * 1e3:.1f} ms, decode "
          f"{t1.gen_tokens} tokens {t1.gen_tps:.1f} tok/s, {steps} steps of "
          f"{cfg.n_layers} K5; the same tokens with K5's plain version; "
          f"launches {counts}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return counts


# Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1 config.json:
# vocab 32000, hidden 4096, ffn 14336, 32 heads of 128 over 8 kv heads, 8
# experts with top-2, rope theta 1e6, 32 layers), as the GGUF keys a
# converted file carries (arch "llama" with an expert count), read by the
# port's config_from_metadata; depth cut from 32 layers to MOE_LAYERS (8
# layers: 22.5 GB of dense bf16 experts; 32 layers would need 90 GB, more
# than the card holds); synthetic weights from a seed: q4_k q / k / output
# projections, q6_k v projections and head, an f32 router and dense bf16
# expert stacks made on the card
MIXTRAL_8X7B_MD = {
    "general.architecture": "llama", "llama.vocab_size": 32000,
    "llama.embedding_length": 4096, "llama.block_count": 32,
    "llama.feed_forward_length": 14336, "llama.context_length": 32768,
    "llama.attention.head_count": 32, "llama.attention.head_count_kv": 8,
    "llama.attention.layer_norm_rms_epsilon": 1e-5,
    "llama.rope.freq_base": 1000000.0, "llama.rope.dimension_count": 128,
    "llama.expert_count": 8, "llama.expert_used_count": 2}
MOE_LAYERS = 8
# greedy tokens of each MoE single-stream run: one device chunk
# (FAST_DECODE_K steps, which a shorter request computes all the same)
MOE_DEPTH = 32
# one MoE block through the dense-EP and sorted-EP forms against the
# gather form, on the same rows and routes: |err| <= MOE_FORM_TOL (1 +
# |want|) (their products' other shapes round otherwise; the fixtures'
# tolerance)
MOE_FORM_TOL = 2e-2
# two paths of the MoE model run under one path's experts
# (`_Routes(force=...)`), and what is left between them is rounding, which
# grows from ~0.5% of the hidden state after the first layer to ~1.6% after
# the eighth: every router weight within ROUTER_TOL of the first path's,
# and logits within MOE_LOGIT_TOL (the forms' last-token logits; a token
# departure's two logits on the first path). Set from the sound runs'
# readings (PERF.md, the MoE findings): router weights up to 0.0250
# apart, logits up to 0.0938, departures at gaps up to 0.0625
ROUTER_TOL = 2 ** -5
MOE_LOGIT_TOL = 2 ** -3


def moe_model(seed: int = 0) -> Model:
    """Mixtral-8x7B's widths at MOE_LAYERS layers, synthetic "q4_k_m"
    weights: zero-mean q4_k (`rand_q4k_centered`) q / k / o, q6_k v and
    head, f32 router, bf16 experts made on the card."""
    cfg = dataclasses.replace(config_from_metadata(MIXTRAL_8X7B_MD),
                              n_layers=MOE_LAYERS)
    return synthetic_model(cfg, "q4_k_m", seed=seed, device=DEV)


class _Routes:
    """Every router decision of a run: wraps models.llama.forward /
    forward_paged (each call's token and position rows) and
    models.llama._top_k (each layer's softmax weights), keeping device
    tensors only (no sync inside a device chunk). `decisions(seqs)` maps
    each row at position p with token t to the one sequence of `seqs`
    holding t at p, and returns, per sequence, {(p, layer): (the k chosen
    experts as a set, the k-th less the (k+1)-th weight, the E weights, the
    k chosen in order)}; a re-evaluated position keeps its last decision.

    With `force=(seqs, decisions)` from an earlier run, every row that
    token and position place in one of those sequences (in exactly one, or
    at position 0, where they all hold BOS) takes that run's experts at
    its layer in place of its own top-k, weighted by its own softmax. Two
    paths then run the same experts, and what is left between them is
    their rounding; the recorded weights stay the row's own, so
    `decisions` gives the experts that the row would have chosen."""

    def __init__(self, force=None):
        self.force = None if force is None else _route_table(*force)

    def __enter__(self):
        self.calls: list = []
        self.orig = (llama.forward, llama.forward_paged, llama._top_k,
                     ds2.forward)
        real_top_k = self.orig[2]

        def wrap(fn):
            def forward(params, cfg, tokens, positions, *a, **k):
                # copies: an engine may refill its token buffers in place
                self.calls.append((tokens.clone(), positions.clone(), []))
                return fn(params, cfg, tokens, positions, *a, **k)
            return forward

        def top_k(w, k):
            vals, idx = real_top_k(w, k)
            if not self.calls:
                return vals, idx
            tokens, positions, ws = self.calls[-1]
            li = len(ws)
            ws.append(w.detach().clone())
            if self.force is None:
                return vals, idx
            tt, ti, th = self.force  # (S, n), (S, L, n, k), (S, L, n)
            tok, pos = tokens.reshape(-1), positions.reshape(-1)
            pc = pos.clamp(0, tt.shape[1] - 1)
            match = ((tt[:, pc] == tok[None]) & (pos >= 0)[None]
                     & (pos < tt.shape[1])[None])  # (S, N)
            hits = match.sum(0)
            s = match.int().argmax(0)
            use = (((hits == 1) | ((pos == 0) & (hits > 0)))
                   & th[s, li, pc])
            idx = torch.where(use[:, None], ti[s, li, pc], idx)
            return w.gather(-1, idx), idx

        llama.forward, llama.forward_paged = map(wrap, self.orig[:2])
        ds2.forward = wrap(self.orig[3])
        llama._top_k = top_k
        return self

    def __exit__(self, *exc):
        (llama.forward, llama.forward_paged, llama._top_k,
         ds2.forward) = self.orig

    def decisions(self, seqs: list[list[int]], k: int) -> list[dict]:
        out: list[dict] = [{} for _ in seqs]
        for tokens, positions, ws in self.calls:
            toks = tokens.reshape(-1).tolist()
            pos = positions.reshape(-1).tolist()
            for li, w in enumerate(ws):
                s = torch.sort(w.float(), dim=-1, descending=True,
                               stable=True)
                idx = s.indices[:, :k].tolist()
                margin = (s.values[:, k - 1] - s.values[:, k]).tolist()
                rows = w.float().tolist()
                for row, (t, p) in enumerate(zip(toks, pos)):
                    hits = [r for r, sq in enumerate(seqs)
                            if 0 <= p < len(sq) and sq[p] == t]
                    if len(hits) == 1:
                        out[hits[0]][(p, li)] = (frozenset(idx[row]),
                                                 margin[row], rows[row],
                                                 idx[row])
        return out


def _route_table(seqs: list[list[int]], decisions: list[dict]):
    """`_Routes`'s force tables on the card: each sequence's tokens (S, n)
    (-1 past its end), its decisions' experts in order (S, L, n, k) and
    where it has one (S, L, n)."""
    n = max(len(sq) for sq in seqs)
    L = 1 + max(li for d in decisions for _, li in d)
    k = len(next(iter(decisions[0].values()))[3])
    tt = np.full((len(seqs), n), -1, np.int64)
    ti = np.zeros((len(seqs), L, n, k), np.int64)
    th = np.zeros((len(seqs), L, n), bool)
    for s, (sq, dec) in enumerate(zip(seqs, decisions)):
        tt[s, :len(sq)] = sq
        for (p, li), d in dec.items():
            ti[s, li, p] = d[3]
            th[s, li, p] = True
    return tuple(torch.from_numpy(a).to(DEV) for a in (tt, ti, th))


def _route_drift(a: dict, b: dict, upto: int):
    """Two runs of one sequence, the second under the first's experts
    (`_Routes(force=...)`), over the decisions at positions below `upto`:
    (the largest difference of one router weight, its (position, layer),
    and the decisions where the second run's own weights would choose
    other experts as [(position, layer, gap)], gap the largest weight of
    an expert it was not given less the smallest of one it was given: at
    most twice the first)."""
    drift, at, ties = 0.0, None, []
    for key in sorted(a.keys() & b.keys()):
        if key[0] >= upto:
            continue
        wa, wb, given = a[key][2], b[key][2], a[key][0]
        d = max(abs(x - y) for x, y in zip(wa, wb))
        if d > drift:
            drift, at = d, key
        if b[key][0] != given:
            ties.append((*key, max(w for e, w in enumerate(wb)
                                   if e not in given)
                         - min(wb[e] for e in given)))
    return drift, at, ties


def _check_routes(a: dict, b: dict, upto: int, what: str) -> str:
    """`_route_drift` held to ROUTER_TOL: every router weight of the
    forced run within it of the first run's (so every decision it would
    have taken otherwise a near-tie of its own weights, within twice
    that). Returns what it read."""
    _check(len(a.keys() & b.keys()) >= upto,
           f"{what}: the router decisions were not recorded")
    drift, at, ties = _route_drift(a, b, upto)
    worst = max(ties, key=lambda t: t[2], default=None)
    note = (f"router weights within {drift:.4g} (at position and layer "
            f"{at}); {len(ties)} decision(s) the forced run would have "
            f"taken otherwise"
            + (f", gaps up to {worst[2]:.3g} (position {worst[0]} layer "
               f"{worst[1]})" if worst else ""))
    print(f"router: {what}: {note}", flush=True)
    _check(drift <= ROUTER_TOL, f"{what}: router weights {drift} apart at "
           f"position and layer {at} under the same experts (bound "
           f"{ROUTER_TOL})")
    return note


def _moe_same(single: Engine, prompt, got, want, route_got: dict,
              route_want: dict, what: str) -> None:
    """`_same_or_near_tie` for a run (got) made under the experts of the
    run it is held to (want, route_want: `_Routes(force=...)`): the router
    within ROUTER_TOL over the positions the two share (`_check_routes`),
    and a token departure at step i a near-tie of the single-stream logits
    of prompt + got[:i], read under want's experts too: the two tokens'
    logits within MOE_LOGIT_TOL."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    n = len(prompt) + (len(want) if i is None else i)
    _check_routes(route_want, route_got, n, what)
    if got == want:
        return
    _check(i is not None, f"{what}: one reply stopped early: {got} {want}")
    single.reset_context()
    seq = list(prompt) + want
    with _Routes(force=([seq], [route_want])):
        lg = single.eval_tokens(list(prompt) + got[:i], 0).float()
    a, b = lg[got[i]].item(), lg[want[i]].item()
    _check(abs(a - b) <= MOE_LOGIT_TOL,
           f"{what}: tokens part at step {i} ({got[i]} vs {want[i]}), "
           f"single-stream logits {a} vs {b} (bound {MOE_LOGIT_TOL})")
    print(f"near-tie: {what}, step {i}: tokens {got[i]} / {want[i]}, "
          f"single-stream logits {a:.6f} / {b:.6f}", flush=True)


def _moe_run(eng: Engine, prompt, gp, routes: bool = True, force=None):
    """One request from an empty context: (tokens, timings, launches, per-
    step launches, the request's router decisions or None); `force`, a
    run's (tokens, decisions), gives this run that run's experts."""
    eng.reset_context()
    _build.launches.clear()
    with _StepLaunches() as rec:
        if routes:
            with _Routes(force=force and ([list(prompt) + force[0]],
                                          [force[1]])) as ro:
                r = eng.generate(prompt, gp)
        else:
            r = eng.generate(prompt, gp)
    dec = (ro.decisions([list(prompt) + r.tokens],
                        eng.cfg.n_experts_used)[0] if routes else None)
    return r.tokens, eng.last_timings, dict(_build.launches), rec, dec


def _moe_forms(model, prompt) -> str:
    """The three MoE forms, gather (default), dense-EP and sorted-EP: the
    first layer's MoE block on the same 300 rows (normal, the RMS-normed
    input's spread), each form's output within MOE_FORM_TOL (1 + |want|)
    of the gather form's (the same routes: the router is shared); then
    the 300-token prompt as one chunk from position 0 through each form,
    the dense-EP and sorted-EP ones under the gather form's experts, whose
    last-token logits are held to the gather form's within MOE_LOGIT_TOL
    and whose routers to `_check_routes`."""
    cfg = model.cfg
    layer = model.params["layers"][0]
    x = torch.randn(1, len(prompt), cfg.hidden_size, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(3)
                    ).to(torch.bfloat16)
    blocks = {}
    notes = []
    for form in ("gather", "dense_ep", "sorted_ep"):
        c = dataclasses.replace(cfg, moe_dense_ep=form == "dense_ep",
                                moe_sorted_ep=form == "sorted_ep")
        with torch.inference_mode():
            blocks[form] = llama._moe_ffn(x, layer, c).float()
    want = blocks["gather"]
    for form in ("dense_ep", "sorted_ep"):
        err = (blocks[form] - want).abs()
        worst = float((err / (MOE_FORM_TOL * (1 + want.abs()))).max())
        _check(worst <= 1.0, f"MoE {form}: the block off the gather "
               f"form's, max abs err {float(err.max())}")
        notes.append(f"{form} block max abs err {float(err.max()):.4g} "
                     f"(worst / tol {worst:.3g})")
    out = {}
    moe_in: dict = {}  # each form's MoE block inputs, layer by layer
    real_moe_ffn = llama._moe_ffn

    def moe_ffn(x, layer, c, tp=None):
        moe_in.setdefault(form, []).append(x[0].float())
        return real_moe_ffn(x, layer, c, tp)

    for form in ("gather", "dense_ep", "sorted_ep"):
        c = dataclasses.replace(cfg, moe_dense_ep=form == "dense_ep",
                                moe_sorted_ep=form == "sorted_ep")
        cache = init_cache(cfg.n_layers, 1, len(prompt), cfg.n_kv_heads,
                           cfg.head_dim, device=DEV)
        force = None if form == "gather" else ([prompt], [out["gather"][1]])
        with _Routes(force=force) as ro, torch.inference_mode(), \
                mock.patch.object(llama, "_moe_ffn", moe_ffn):
            lg, _ = llama.forward(model.params, c,
                                  torch.tensor([prompt], device=DEV),
                                  torch.arange(len(prompt),
                                               device=DEV)[None],
                                  cache, last_only=True)
        out[form] = (lg[0, -1].float().cpu().numpy(),
                     ro.decisions([prompt], cfg.n_experts_used)[0])
    # how far rounding carries the hidden state, layer by layer: the
    # dense-EP form's MoE inputs against the gather form's under its
    # experts, |a - b| / |a| per row
    rel = [((b - a).norm(dim=-1) / a.norm(dim=-1)).cpu()
           for a, b in zip(moe_in["gather"], moe_in["dense_ep"])]
    notes.append("dense_ep MoE inputs against the gather form's, relative "
                 "difference per layer (median / max): " + ", ".join(
                     f"{float(r.median()):.4f} / {float(r.max()):.4f}"
                     for r in rel))
    del moe_in
    want, route = out["gather"]
    _check(np.isfinite(want).all() and want.shape == (cfg.vocab_size,),
           "MoE gather form: logits not finite")
    for form in ("dense_ep", "sorted_ep"):
        got, r = out[form]
        _check(len(r.keys() & route.keys()) == len(prompt) * cfg.n_layers,
               f"MoE {form}: the router decisions were not recorded")
        routes = _check_routes(route, r, len(prompt), f"MoE {form}")
        err = float(np.abs(got - want).max())
        _check(err <= MOE_LOGIT_TOL,
               f"MoE {form}: last logits off the gather form's, max abs "
               f"err {err} (bound {MOE_LOGIT_TOL})")
        notes.append(f"{form} last logits max abs err {err:.4g} ({routes})")
    return "; ".join(notes)


def phase_moe_decode(card: str) -> tuple[dict, Model]:
    """Mixtral-8x7B's widths (MOE_LAYERS of 32 layers, 8 experts, top-2)
    on the card: a 300-token prompt (K3, one chunk from position 0 through
    K4) and MOE_DEPTH greedy tokens in the device chunk on the bf16 cache
    (every step 24 K1, 9 K2, 8 K5), then on the Q8 cache (8 K6 a step),
    each against the same run with the attention kernel's plain version,
    and the bf16 run against one with flash prefill off; MOE_DEPTH seeded
    stochastic tokens twice (the same tokens); a paged wave of 4 requests
    through BatchedEngine (every step 24 K7, 9 K3, 8 K8), each against its
    single-stream tokens; each comparison's second run under the first
    run's experts, held by `_moe_same` (router weights within ROUTER_TOL,
    a token departure a near-tie of MOE_LOGIT_TOL); the dense-EP and
    sorted-EP forms against the gather form (`_moe_forms`); the MoE
    block's device time alone (`_dev_ms`) for one sequence's step and for
    four, and the bytes the step reads (every expert) against the k
    experts' own, then the 300-row prompt chunk, each with the products'
    f32 output and with a bf16 one. Returns (launches, the model), which
    phase_profiled profiles."""
    t0 = time.perf_counter()
    model = moe_model()
    cfg = model.cfg
    made = time.perf_counter() - t0
    layer = model.params["layers"][0]
    _check(layer["wv"].kind == "q6_k" and layer["wq"].kind == "q4_k"
           and model.params["output"].kind == "q6_k"
           and layer["ffn_gate_exps"].shape == (8, 14336, 4096),
           "Mixtral widths: unexpected synthetic params")
    rng = np.random.default_rng(7)
    prompt = [1] + rng.integers(3, cfg.vocab_size, size=299).tolist()
    sampler = SamplerParams(temperature=0.0, rep_pen=1.0)
    gp = GenParams(max_length=MOE_DEPTH, bypass_eos=True, sampler=sampler)
    eng = Engine(model, max_context=2048, device=DEV)
    _check(eng.use_flash_prefill, "flash prefill (K4) is off on the card")
    # warm-up: the prompt's prefill bucket and the grouped expert shapes
    eng.generate(prompt, GenParams(max_length=4, bypass_eos=True,
                                   sampler=sampler))
    counts: dict = {}

    def add(c):
        for kk, v in c.items():
            counts[kk] = counts.get(kk, 0) + v

    # the timed run (no router recording), then the recorded comparisons
    L = cfg.n_layers
    # a step: q / k / o through K1, v and the head through K2
    step = {"K1": 3 * L, "K2": L + 1, "K5": L}
    toks, t1, c1, rec, _ = _moe_run(eng, prompt, gp, routes=False)
    add(c1)
    steps = _check_steps(rec, 1, {**step, "K4": 0}, "MoE bf16")
    _check(c1.get("K4", 0) == L and c1.get("K3", 0) > 0,
           f"MoE prefill: launches {c1}")
    _check(len(toks) == MOE_DEPTH
           and all(0 <= t < cfg.vocab_size for t in toks),
           f"MoE: tokens {toks}")
    base, _, _, _, route = _moe_run(eng, prompt, gp)
    _check(base == toks, f"MoE greedy decode not repeatable: {base} {toks}")
    with mock.patch.object(flash_decode, "decode_attention_batched",
                           _k5_plain):
        plain, *_, route_p = _moe_run(eng, prompt, gp, force=(toks, route))
    _moe_same(eng, prompt, plain, toks, route_p, route,
              "MoE bf16, K5 against its plain version")
    eng.use_flash_prefill = False
    noflash, tnf, *_, route_nf = _moe_run(eng, prompt, gp,
                                          force=(toks, route))
    eng.use_flash_prefill = True
    _moe_same(eng, prompt, noflash, toks, route_nf, route,
              "MoE bf16, flash prefill off")

    # seeded stochastic chunks: the same tokens twice, K1 / K2 / K5 inside
    sgp = GenParams(max_length=MOE_DEPTH, bypass_eos=True,
                    sampler=SamplerParams(temperature=0.8, top_p=0.9,
                                          min_p=0.05, rep_pen=1.1, seed=11))
    s1, _, cs, srec, _ = _moe_run(eng, prompt, sgp, routes=False)
    s2, ts, *_ = _moe_run(eng, prompt, sgp, routes=False)
    _check(s1 == s2 and len(s1) == MOE_DEPTH,
           f"MoE stochastic chunk not repeatable: {s1} {s2}")
    _check_steps(srec, 1, step, "MoE stochastic")
    add(cs)

    # the Q8 cache: K6, against K6's plain version
    qeng = Engine(model, max_context=2048, device=DEV, quantkv=1)
    qtoks, tq, cq, qrec, qroute = _moe_run(qeng, prompt, gp)
    add(cq)
    qsteps = _check_steps(qrec, 1, {"K6": L, "K5": 0}, "MoE Q8")
    with mock.patch.object(flash_decode, "decode_attention_batched_q8",
                           _k6_plain):
        qplain, *_, qroute_p = _moe_run(qeng, prompt, gp,
                                        force=(qtoks, qroute))
    _moe_same(qeng, prompt, qplain, qtoks, qroute_p, qroute,
              "MoE Q8, K6 against its plain version")
    del qeng
    torch.cuda.empty_cache()

    # one paged wave of 4 requests, each against its single-stream tokens
    prompts = [[1] + rng.integers(3, cfg.vocab_size, size=n - 1).tolist()
               for n in (100, 170, 240, 300)]
    alone, routes_alone = [], []
    for p in prompts:
        t_, *_, r_ = _moe_run(eng, p, gp)
        alone.append(t_)
        routes_alone.append(r_)
    beng = batch_engine.BatchedEngine(model, max_context=1024, n_slots=4,
                                      paged=True, device=DEV)
    try:
        _build.launches.clear()
        with _StepLaunches() as wrec, _Routes(force=(
                [p + t for p, t in zip(prompts, alone)], routes_alone)) as ro:
            res, secs = _serve_together(beng, prompts, [gp] * 4)
        wave = dict(_build.launches)
    finally:
        beng.shutdown()
    add(wave)
    wsteps = _check_steps(wrec, 4, {"K7": 3 * L, "K3": L + 1, "K8": L,
                                    "K5": 0}, "MoE paged wave")
    got = [r.tokens for r in res]
    wroutes = ro.decisions([p + g for p, g in zip(prompts, got)],
                           cfg.n_experts_used)
    for p, g, w, ra, rw in zip(prompts, got, alone, routes_alone, wroutes):
        _moe_same(eng, p, g, w, rw, ra, "MoE paged wave against "
                  "single-stream")
    forms = _moe_forms(model, prompt)

    # the MoE block alone on the device: one sequence's step and four
    # sequences' (every expert each), and the 300-row prompt chunk (grouped
    # by expert: a host read inside, so CUDA events around the call), each
    # with the products' f32 output (the port's) and with a bf16 one
    x1 = torch.randn(1, 1, cfg.hidden_size, device=DEV, dtype=torch.bfloat16)
    x4 = torch.randn(4, 1, cfg.hidden_size, device=DEV, dtype=torch.bfloat16)
    xp = torch.randn(1, len(prompt), cfg.hidden_size, device=DEV,
                     dtype=torch.bfloat16)
    bf16_out = mock.patch.object(
        moe_ops, "_product",
        lambda a, w: torch.matmul(a, w.transpose(-1, -2)).float())
    ms = {}
    with torch.inference_mode():
        for out_dtype in ("f32", "bf16", "f32", "bf16"):
            with bf16_out if out_dtype == "bf16" else contextlib.nullcontext():
                ms.setdefault(out_dtype, []).append((
                    _dev_ms(lambda: llama._moe_ffn(x1, layer, cfg)),
                    _dev_ms(lambda: llama._moe_ffn(x4, layer, cfg)),
                    _event_ms(lambda: llama._moe_ffn(xp, layer, cfg))))
    ms1, ms4, msp = (min(r[j] for r in ms["f32"]) for j in range(3))
    b1, b4, bp = (min(r[j] for r in ms["bf16"]) for j in range(3))
    k, E = cfg.n_experts_used, cfg.n_experts
    expert_b = 3 * cfg.hidden_size * cfg.intermediate_size * 2
    own = k * expert_b  # the k experts' own bytes, one layer
    print(f"Mixtral-8x7B widths ({cfg.n_layers} of 32 layers, {E} experts "
          f"of {cfg.intermediate_size}, top-{k}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}; q4_k q/k/o, q6_k v "
          f"and head, bf16 experts; {card}): synthetic weights {made:.1f} "
          f"s; prefill {t1.prompt_tokens} tokens {t1.prompt_time * 1e3:.1f}"
          f" ms (flash prefill off: {tnf.prompt_time * 1e3:.1f} ms), decode "
          f"{t1.gen_tokens} tokens {t1.gen_tps:.2f} tok/s, {steps} steps of "
          f"{step}; Q8 cache: decode {tq.gen_tps:.2f} tok/s, {qsteps} "
          f"steps of {L} K6; stochastic chunk {ts.gen_tps:.2f} tok/s;"
          f" the same tokens with K5's / K6's plain version and with flash "
          f"prefill off (near-ties apart); paged wave of 4 ({secs:.2f} s, "
          f"{wsteps} steps of {3 * L} K7 + {L + 1} K3 + {L} K8) equal to "
          f"single-stream; "
          f"forms against the gather form: {forms}", flush=True)
    print(f"MoE block on the device alone (one layer, every expert read "
          f"once: {E * expert_b / 1e9:.3f} GB): one sequence's step "
          f"{ms1:.4f} ms against the bound of its {k} experts' own "
          f"{own / 1e9:.3f} GB, {own / HBM_BYTES_PER_S * 1e3:.4f} ms (all "
          f"{E}: {E * expert_b / HBM_BYTES_PER_S * 1e3:.4f} ms), "
          f"{ms1 * cfg.n_layers:.3f} ms a token over {cfg.n_layers} layers; "
          f"four sequences' step {ms4:.4f} ms (their experts: at most "
          f"{min(4 * k, E) * expert_b / 1e9:.3f} GB); the 300-row prompt "
          f"chunk {msp:.4f} ms (events, a host read inside); the same with "
          f"the products' output rounded to bf16: {b1:.4f} / {b4:.4f} / "
          f"{bp:.4f} ms (f32 output against it: {ms1 / b1:.3f}x / "
          f"{ms4 / b4:.3f}x / {msp / bp:.3f}x); launches {counts}",
          flush=True)
    del eng, layer
    torch.cuda.empty_cache()
    return counts, model


# DeepSeek-V2-Lite at full depth (27 layers, ~30 GB with its dense bf16
# experts): greedy tokens of each MLA run (the host loop: one forward a
# token) and seeded stochastic ones
DS2_DEPTH = 8  # the MLA host loop pays its time per token
DS2_STOCH = 8


def _plain_matmuls():
    """K1, K2, K2.q8_0 and K3 replaced by their plain versions for a block
    (the MLA and text models' only kernels; the plain versions count no
    launch)."""
    return mock.patch.multiple(
        qm, q4k_matvec=lambda x, qt, i8: qm.q4k_matvec_plain(x, qt, i8),
        q6k_matvec=lambda x, qt, i8: qm.q6k_matvec_plain(x, qt, i8),
        q8_0_matvec=lambda x, qt, i8=True: qm.q8_0_matvec_plain(x, qt, i8),
        kq_matmul=lambda x, qt, magic=False: (
            qm.kq_matmul_magic_plain if magic else qm.kq_matmul_plain)(x, qt))


def phase_deepseek2_decode(card: str) -> tuple[dict, Model, dict]:
    """DeepSeek-V2-Lite's widths at full depth (DEEPSEEK_V2_LITE_MD through
    `synthetic_deepseek2_model`: 27 layers, 16 heads of 128 + 64 roped dims
    over a 512-rank latent, v 128, a dense lead layer of 10944, then 64
    experts of 1408 with top-6 and 2 shared experts, YaRN 40) through
    Engine's MLA branch: a 300-token prompt (one 512-row chunk: every
    q4_k projection through K3, 159 of them) and DS2_DEPTH greedy tokens in
    the host loop (every step 159 K1 and the head's K2, no attention
    kernel: the MLA attention is plain torch, as the JAX module's einsums),
    repeated with the router recorded, then under those experts with K1 /
    K2 / K3's plain versions (`_moe_same`: router weights within
    ROUTER_TOL, a departure a near-tie of MOE_LOGIT_TOL); the same with
    quantkv=1 (the cache stays bf16: the same tokens); DS2_STOCH seeded
    stochastic tokens twice (the same tokens); a fast-forwarded request
    evaluating one prompt token. Then device times alone: one MoE layer's
    step in the every-expert form against the grouped form (this path's),
    with the bytes each reads against the k experts' own; the MoE block's
    step and 512-row chunk; one layer's MLA attention at T = 1; the
    projections no kernel takes (wkv_a_mqa: 576 rows; the lead layer's
    10944-row gate / up and its q8_0 w_down, in_f 10944: dequantized on
    every call, as in JAX). Returns (launches, the model, the block times
    that phase_profiled sets against a token's device time)."""
    import torch.nn.functional as F

    from koboldcpp_tpu_torch.kv.cache import QuantKVCache
    from koboldcpp_tpu_torch.ops import linear as tlinear

    t0 = time.perf_counter()
    model = synthetic_deepseek2_model(DEEPSEEK_V2_LITE_MD, seed=0, device=DEV)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    cfg = model.cfg
    layers = model.params["layers"]
    lead, mlayer = layers[0], layers[1]
    L, E, k, C = cfg.n_layers, cfg.n_experts, cfg.n_experts_used, \
        cfg.hidden_size
    n_moe = sum("ffn_gate_inp" in ly for ly in layers)
    _check(L == 27 and E == 64 and k == 6 and n_moe == 26 and C == 2048
           and cfg.head_dim == 192 and cfg.extras["v_head_dim"] == 128
           and mlayer["ffn_gate_exps"].shape == (64, 1408, 2048)
           and mlayer["wq"].kind == "q4_k" and lead["w_down"].kind == "q8_0"
           and mlayer["wkv_a_mqa"].shape == (576, 2048)
           and model.params["output"].kind == "q6_k",
           "DeepSeek-V2-Lite widths: unexpected synthetic params")
    rng = np.random.default_rng(9)
    prompt = [1] + rng.integers(3, cfg.vocab_size, size=299).tolist()
    sampler = SamplerParams(temperature=0.0, rep_pen=1.0)
    gp = GenParams(max_length=DS2_DEPTH, bypass_eos=True, sampler=sampler)
    eng = Engine(model, max_context=2048, device=DEV)
    _check(eng.mla and not eng.use_flash_prefill and not eng.use_contextshift,
           "DeepSeek-V2-Lite: the engine did not take the MLA branch")
    eng.generate(prompt, GenParams(max_length=2, bypass_eos=True,
                                   sampler=sampler))  # warm-up
    counts: dict = {}

    def add(c):
        for kk, v in c.items():
            counts[kk] = counts.get(kk, 0) + v

    # a step: wq, wkv_b and wo of every layer and the shared experts'
    # three projections of every MoE layer through K1, the head through K2
    n_k1 = 3 * L + 3 * n_moe
    step = {"K1": n_k1, "K2": 1, "K3": 0, "K4": 0, "K5": 0}
    toks, t1, c1, rec, _ = _moe_run(eng, prompt, gp, routes=False)
    add(c1)
    steps = _check_steps(rec, 1, step, "DeepSeek-V2-Lite bf16")
    pre = rec.by_shape.get((1, 512), [])
    _check(len(pre) == 1 and pre[0].get("K3", 0) == n_k1
           and pre[0].get("K2", 0) == 1,
           f"DeepSeek-V2-Lite prefill chunk launches {pre}")
    _check(len(toks) == DS2_DEPTH
           and all(0 <= t < cfg.vocab_size for t in toks),
           f"DeepSeek-V2-Lite: tokens {toks}")
    base, _, _, _, route = _moe_run(eng, prompt, gp)
    _check(base == toks, f"DeepSeek-V2-Lite greedy decode not repeatable: "
           f"{base} {toks}")
    with _plain_matmuls():
        plain, _, cp, _, route_p = _moe_run(eng, prompt, gp,
                                            force=(toks, route))
    _check(not any(cp.get(kk, 0) for kk in ("K1", "K2", "K3")),
           f"DeepSeek-V2-Lite plain run launched {cp}")
    _moe_same(eng, prompt, plain, toks, route_p, route,
              "DeepSeek-V2-Lite, K1 / K2 / K3 against their plain versions")

    # --quantkv 1: the MLA cache stays bf16, as the JAX engine builds it
    qeng = Engine(model, max_context=2048, device=DEV, quantkv=1)
    _check(qeng.cache.k.dtype == torch.bfloat16
           and not isinstance(qeng.cache, QuantKVCache),
           "DeepSeek-V2-Lite: --quantkv changed the MLA cache")
    qtoks, tq, cq, _, _ = _moe_run(qeng, prompt, gp, routes=False)
    add(cq)
    _check(qtoks == toks, f"DeepSeek-V2-Lite quantkv=1: tokens {qtoks}, "
           f"bf16 cache {toks}")
    del qeng
    torch.cuda.empty_cache()

    sgp = GenParams(max_length=DS2_STOCH, bypass_eos=True,
                    sampler=SamplerParams(temperature=0.8, top_p=0.9,
                                          min_p=0.05, rep_pen=1.1, seed=11))
    s1, _, cs, _, _ = _moe_run(eng, prompt, sgp, routes=False)
    s2, ts, *_ = _moe_run(eng, prompt, sgp, routes=False)
    add(cs)
    _check(s1 == s2 and len(s1) == DS2_STOCH,
           f"DeepSeek-V2-Lite stochastic tokens not repeatable: {s1} {s2}")
    _build.launches.clear()
    eng.generate(list(eng.context_tokens) + [7], GenParams(
        max_length=4, bypass_eos=True, sampler=sampler))
    add(dict(_build.launches))
    _check(eng.last_timings.prompt_tokens == 1,
           f"DeepSeek-V2-Lite fast-forward evaluated "
           f"{eng.last_timings.prompt_tokens} prompt tokens")

    # the two decode forms end to end, in turns: the grouped form (this
    # path's: a host read a MoE layer) and every expert (no host read)
    real_gather = llama._moe_gather

    def every_at_t1(xt, *a, every_expert=False, **kw):
        return real_gather(xt, *a, every_expert=every_expert
                           or xt.shape[0] == 1, **kw)

    form_tps: dict = {}
    fgp = GenParams(max_length=16, bypass_eos=True, sampler=sampler)
    for name in ("grouped", "every expert", "every expert", "grouped"):
        with (mock.patch.object(llama, "_moe_gather", every_at_t1)
              if name == "every expert" else contextlib.nullcontext()):
            _, tf, *_ = _moe_run(eng, prompt, fgp, routes=False)
        form_tps.setdefault(name, []).append(tf.gen_tps)

    # device times alone: one MoE layer's step in the two forms, the
    # block's step and chunk, one layer's attention, the no-kernel
    # projections
    gen = torch.Generator(device=DEV).manual_seed(5)
    x1 = torch.randn(1, 1, C, device=DEV, generator=gen).bfloat16()
    xp = torch.randn(1, 512, C, device=DEV, generator=gen).bfloat16()
    wg, wu, wd = (mlayer[n].data["w"] for n in
                  ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"))
    expert_b = 3 * C * cfg.expert_ffn_size * 2
    pos = torch.tensor([[len(eng.context_tokens)]], device=DEV)
    rows, mask = ds2.cache_rows(pos, eng.cache.max_seq)
    xd = torch.randn(1, cfg.intermediate_size, device=DEV,
                     generator=gen).bfloat16()
    ms: dict = {}
    with torch.inference_mode():
        xt = x1.view(1, C)
        router = tlinear.matmul(xt, mlayer["ffn_gate_inp"]).float()
        topw, topi = llama._top_k(torch.softmax(router, dim=-1), k)
        chosen = topi[0].tolist()

        def form(every):
            return lambda: llama._moe_gather(xt, topi, topw, wg, wu, wd,
                                             F.silu, every_expert=every)

        def grouped_products():
            for e in chosen:
                moe_ops.expert_products(xt, wg[e], wu[e], wd[e], F.silu)

        for name, fn, timer in (
                ("every", form(True), _dev_ms),
                ("grouped", form(False), _event_ms),
                ("grouped products", grouped_products, _dev_ms)) * 2:
            ms[name] = min(ms.get(name, 1e9), timer(fn))
        ms["block step"] = _event_ms(lambda: ds2._moe(x1, mlayer, cfg))
        ms["block chunk"] = _event_ms(lambda: ds2._moe(xp, mlayer, cfg))
        ms["attention"] = _dev_ms(lambda: ds2._attention(
            mlayer, cfg, x1, pos, eng.cache.k[1], eng.cache.v[1], rows,
            mask))
        ms["wkv_a_mqa"] = _dev_ms(lambda: tlinear.matmul(
            x1, mlayer["wkv_a_mqa"]))
        ms["lead gate+up"] = _dev_ms(lambda: (
            tlinear.matmul(x1, lead["w_gate"]),
            tlinear.matmul(x1, lead["w_up"])))
        ms["lead w_down"] = _dev_ms(lambda: tlinear.matmul(xd,
                                                           lead["w_down"]))
        ms["lead w_down dequant"] = _dev_ms(lambda: dequant(lead["w_down"]))
    faster = ("grouped" if ms["grouped products"] <= ms["every"]
              else "every-expert")
    no_kernel = (L * ms["wkv_a_mqa"] + ms["lead gate+up"]
                 + ms["lead w_down"])
    print(f"DeepSeek-V2-Lite widths ({L} layers, {E} experts of "
          f"{cfg.expert_ffn_size}, top-{k}, 2 shared, {cfg.n_heads} heads "
          f"of {cfg.head_dim} / v {cfg.extras['v_head_dim']}; zero-mean "
          f"q4_k projections, q8_0 lead w_down, q6_k head, bf16 experts; "
          f"{card}): synthetic weights {made:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; prefill "
          f"{t1.prompt_tokens} tokens {t1.prompt_time * 1e3:.1f} ms, decode "
          f"{t1.gen_tokens} tokens {t1.gen_tps:.2f} tok/s ({steps} steps of "
          f"{step}); quantkv=1 (bf16 MLA cache) {tq.gen_tps:.2f} tok/s, the "
          f"same tokens; stochastic {ts.gen_tps:.2f} tok/s, repeatable; the "
          f"same tokens with K1 / K2 / K3's plain versions (near-ties "
          f"apart); decode of 16 tokens in turns, grouped / every expert "
          f"at T = 1: {' ; '.join(f'{a:.2f}' for a in form_tps['grouped'])}"
          f" / {' ; '.join(f'{a:.2f}' for a in form_tps['every expert'])} "
          f"tok/s; launches {counts}", flush=True)
    print(f"DeepSeek-V2-Lite MoE step, one layer on the device alone: every "
          f"expert {ms['every']:.4f} ms reading {E * expert_b / 1e9:.3f} GB "
          f"(bound {E * expert_b / HBM_BYTES_PER_S * 1e3:.4f} ms); grouped "
          f"{ms['grouped']:.4f} ms with its host read of the group bounds "
          f"(events), its products alone {ms['grouped products']:.4f} ms "
          f"reading the {k} experts' own {k * expert_b / 1e9:.4f} GB (bound "
          f"{k * expert_b / HBM_BYTES_PER_S * 1e3:.4f} ms): {faster} faster; "
          f"the block (router, grouped experts, shared expert) "
          f"{ms['block step']:.4f} ms a step, {ms['block chunk']:.4f} ms a "
          f"512-row chunk (events); one layer's MLA attention at T = 1 over "
          f"{int(pos)} + 1 rows {ms['attention']:.4f} ms; no kernel (as in "
          f"JAX): wkv_a_mqa (576 x 2048) {ms['wkv_a_mqa']:.4f} ms a layer, "
          f"the lead layer's gate + up (10944 rows) {ms['lead gate+up']:.4f}"
          f" ms, its q8_0 w_down (in_f 10944) {ms['lead w_down']:.4f} ms "
          f"(dequant alone {ms['lead w_down dequant']:.4f} ms): "
          f"{no_kernel:.3f} ms a token", flush=True)
    del eng
    torch.cuda.empty_cache()
    return counts, model, {"moe": ms["block step"], "attention":
                           ms["attention"], "no kernel": no_kernel,
                           "n_moe": n_moe}


# tokens (and batched steps) of each profiled window: one device chunk
# (engine.FAST_DECODE_K), which a shorter request computes all the same
PROFILE_DEPTH = 32


def _decode_idle_share(eng: Engine, prompt: list[int], sampler,
                       rows: dict | None = None) -> str:
    """Device busy time against the wall time of a fast-forwarded request
    that decodes PROFILE_DEPTH greedy tokens."""
    eng.generate(prompt, GenParams(max_length=8, sampler=sampler))
    return _idle_share(lambda: eng.generate(prompt, GenParams(
        max_length=PROFILE_DEPTH, bypass_eos=True, sampler=sampler)), rows)


def _idle_share(run, rows_out: dict | None = None) -> str:
    """Device busy time (sum of kernel times, one stream) against the wall
    time of run(), under torch.profiler; rows_out, if given, receives each
    device row's time in microseconds by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only: an op's row repeats its kernels' time
    rows = [(us, k) for k, (us, _) in profile_scan.device_rows(prof).items()]
    busy_us = sum(t for t, _ in rows)
    if rows_out is not None:
        for t, k in rows:
            rows_out[k] = rows_out.get(k, 0.0) + t
    if busy_us <= 0:
        return "device time not measured (the profiler saw no kernels)"
    top = ", ".join(f"{k[:40]} {t / 1e3:.2f} ms"
                    for t, k in sorted(rows, reverse=True)[:6])
    return (f"wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} "
            f"ms, idle share {1 - busy_us / wall_us:.3f}; top: {top}")


def phase_profiled(card: str, moe: Model, mla: Model,
                   mla_ms: dict) -> None:
    """The device idle share, under torch.profiler, of the synthetic 1.1B
    q4_k: a fast-forwarded single-stream request decoding PROFILE_DEPTH
    (32) greedy tokens,
    the same under KCPP_FFN_FUSED=1, the 300-token prefill as one chunk,
    then PROFILE_DEPTH batched steps of 8
    fast-forwarded greedy requests (8 slots) and of 16 (16 slots under
    KCPP_SBQ=1), the scan path, then a fast-forwarded request of the
    Mixtral-widths model `moe` (phase_moe_decode's) and of the
    DeepSeek-V2-Lite model `mla` (phase_deepseek2_decode's, with the MoE
    block's and the attention's share of a token from its device times
    alone, `mla_ms`). A
    profiler session slows every later decode of the process, so this runs
    after every timed phase; the fast-forwarded single-stream request is
    timed just before its session and once more after it."""
    model = synthetic_model(TINYLLAMA_1_1B, "q4_k", seed=0, device=DEV)
    sampler = SamplerParams(temperature=0.0, rep_pen=1.0)
    gp = GenParams(max_length=DEPTH, bypass_eos=True, sampler=sampler)
    prompt = [1] + np.random.default_rng(1).integers(
        3, 32000, size=299).tolist()
    eng = Engine(model, max_context=2048, device=DEV)
    eng.generate(prompt, gp)
    eng.generate(prompt, gp)
    before_tps = eng.last_timings.gen_tps
    rows: dict = {}
    idle = _decode_idle_share(eng, prompt, sampler, rows)
    eng.generate(prompt, gp)
    after_tps = eng.last_timings.gen_tps
    print(f"greedy decode, {PROFILE_DEPTH} tokens under torch.profiler "
          f"({card}): {idle}; "
          f"the fast-forwarded request after it: decode {after_tps:.1f} "
          f"tok/s (before it: {before_tps:.1f})", flush=True)
    # K1's rows (89 a token: 88 layer projections and the head) and any
    # separate activation-prep launch left on the path
    mv = {k: t for k, t in rows.items() if "q4k_" in k and "sbq" not in k}
    prep = {k: t for k, t in rows.items()
            if "act_prep" in k or "group_sums" in k}
    print(f"q4_k matvec rows of the {PROFILE_DEPTH} profiled tokens: "
          f"{sum(mv.values()) / 1e3:.2f} ms, "
          f"{sum(mv.values()) / PROFILE_DEPTH / 1e3:.4f} ms per token "
          f"({', '.join(k[:48] for k in mv)}); activation-prep rows: "
          f"{', '.join(f'{k[:48]} {t / 1e3:.2f} ms' for k, t in prep.items()) or 'none'}",
          flush=True)
    _check(bool(mv), "the profile saw no q4_k matvec row")
    _check(not prep, f"an activation-prep launch remains on the q4_k "
           f"decode path: {list(prep)}")
    with _env(KCPP_FFN_FUSED="1", KCPP_SBQ="0"):
        eng.generate(prompt, gp)
        idle = _decode_idle_share(eng, prompt, sampler)
    print(f"greedy decode under KCPP_FFN_FUSED=1, {PROFILE_DEPTH} tokens "
          f"under "
          f"torch.profiler ({card}): {idle}", flush=True)

    def prefill():  # the 300-token prompt as one chunk from position 0
        eng.reset_context()
        with torch.inference_mode():
            eng._eval_chunk(prompt, 0)
        torch.cuda.synchronize()

    prefill()
    idle = _idle_share(prefill)
    print(f"prefill of the 300-token prompt (88 K3 at T=512, 22 K4) under "
          f"torch.profiler ({card}): {idle}", flush=True)
    del eng
    rng = np.random.default_rng(2)
    prompts = [[1] + rng.integers(3, 32000, size=int(n) - 1).tolist()
               for n in rng.integers(100, 301, size=16)]
    gp_win = [GenParams(max_length=PROFILE_DEPTH, bypass_eos=True,
                     sampler=sampler)] * 16
    for n_slots, env in ((8, {}), (16, {"KCPP_SBQ": "1"})):
        beng = batch_engine.BatchedEngine(model, max_context=2048,
                                          n_slots=n_slots, device=DEV)
        try:
            with _env(**env):
                ps, gs = prompts[:n_slots], gp_win[:n_slots]
                _serve_together(beng, ps, gs)
                # fast-forwarded prompts: one 16-row wave, then
                # PROFILE_DEPTH steps
                idle = _idle_share(lambda: _serve_together(beng, ps, gs))
        finally:
            beng.shutdown()
        print(f"batched 1.1B (slot cache{', KCPP_SBQ=1' if env else ''}), "
              f"{PROFILE_DEPTH} batched steps of {n_slots} greedy requests "
              f"under torch.profiler: {idle}", flush=True)
    # the scan decode path's entry point: PROFILE_DEPTH greedy tokens from
    # position 64 over a pooled cache, as `python -m koboldcpp_tpu_torch.tools.
    # profile_scan scan` runs them
    res = profile_scan.profile("scan", TINYLLAMA_1_1B, PROFILE_DEPTH, DEV,
                               params=model.params)
    _check(res["idle_share"] is not None,
           "profile_scan: the profiler saw no device kernels")
    top = ", ".join(f"{k[:40]} {us:.1f} us x{n:.2f}"
                    for k, us, n in res["ops"][:5])
    print(f"tools/profile_scan.py scan, {PROFILE_DEPTH} tokens under "
          f"torch.profiler "
          f"({card}): wall {res['wall_ms']:.1f} ms, device busy "
          f"{res['busy_ms']:.1f} ms, idle share {res['idle_share']:.3f}; "
          f"top five ops per step: {top}", flush=True)
    del model
    torch.cuda.empty_cache()
    # the Mixtral-widths MoE model that phase_moe_decode built: a
    # fast-forwarded request of PROFILE_DEPTH greedy tokens
    eng = Engine(moe, max_context=2048, device=DEV)
    rows = {}
    idle = _decode_idle_share(eng, prompt, sampler, rows)
    print(f"Mixtral widths ({moe.cfg.n_layers} layers) greedy decode, "
          f"{PROFILE_DEPTH} tokens under torch.profiler ({card}): {idle}; "
          f"device busy {sum(rows.values()) / PROFILE_DEPTH / 1e3:.3f} ms a "
          f"token", flush=True)
    del eng
    torch.cuda.empty_cache()
    _mla_window(card, mla, mla_ms, prompt, sampler)


# decode tokens of the DeepSeek-V2-Lite profiled window (the profiler's
# processing of a host-loop token's events takes seconds), and MoE block
# calls profiled for its device time alone
MLA_PROFILE_DEPTH = 8
MLA_MOE_CALLS = 10


def _mla_window(card: str, mla: Model, mla_ms: dict, prompt, sampler) -> None:
    """phase_profiled's window of the DeepSeek-V2-Lite model (the host
    loop, one forward a token): a fast-forwarded request (one prompt token,
    then MLA_PROFILE_DEPTH decode steps) under torch.profiler, its idle
    share and device busy time a token; a MoE block's device time alone
    (kernel time of MLA_MOE_CALLS T=1 calls of `deepseek2._moe` under the
    profiler: the block's host read of the group bounds leaves the device
    idle, which CUDA events would count) and the shares of a token that it
    (26 MoE layers), the MLA attention (`mla_ms`, device alone) and the
    no-kernel projections account for."""
    eng = Engine(mla, max_context=2048, device=DEV)
    eng.generate(prompt, GenParams(max_length=4, sampler=sampler))
    rows: dict = {}
    idle = _idle_share(lambda: eng.generate(prompt, GenParams(
        max_length=MLA_PROFILE_DEPTH, bypass_eos=True, sampler=sampler)),
        rows)
    busy = sum(rows.values()) / MLA_PROFILE_DEPTH / 1e3  # ms a token
    del eng
    layer = mla.params["layers"][1]
    x1 = torch.randn(1, 1, mla.cfg.hidden_size, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(5)
                     ).bfloat16()
    moe_rows: dict = {}
    with torch.inference_mode():
        ds2._moe(x1, layer, mla.cfg)
        _idle_share(lambda: [ds2._moe(x1, layer, mla.cfg)
                             for _ in range(MLA_MOE_CALLS)], moe_rows)
    moe = sum(moe_rows.values()) / MLA_MOE_CALLS / 1e3
    _check(busy > 0 and moe > 0,
           "DeepSeek-V2-Lite: the profiler saw no device kernels")
    n_moe, L = mla_ms["n_moe"], mla.cfg.n_layers
    print(f"DeepSeek-V2-Lite widths ({L} layers) greedy decode, "
          f"{MLA_PROFILE_DEPTH} tokens under torch.profiler ({card}): "
          f"{idle}; device busy {busy:.3f} ms a token; a MoE block's step "
          f"{moe:.4f} ms of device time alone (profiled; "
          f"{mla_ms['moe']:.4f} ms between CUDA events, host read "
          f"included): the MoE blocks ~{n_moe * moe / busy:.3f} of a "
          f"token's device time, the MLA attention ~"
          f"{L * mla_ms['attention'] / busy:.3f} ({L} x "
          f"{mla_ms['attention']:.4f} ms), the projections no kernel takes "
          f"~{mla_ms['no kernel'] / busy:.3f}", flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4. continuous batching: the synthetic 1.1B through BatchedEngine
# ---------------------------------------------------------------------------

def _serve_together(eng, prompts, params) -> tuple[list, float]:
    """Submit one request per prompt so that the worker admits them all in
    one tick (the slot and paged runs then prefill in the same waves), and
    wait for them. Returns (results, wall seconds)."""
    t0 = time.perf_counter()
    with eng._admit_lock:  # the worker admits none until all are queued
        reqs = [eng.submit(p, gp) for p, gp in zip(prompts, params)]
    for r in reqs:
        _check(r.done.wait(600), "a batched request did not finish")
    secs = time.perf_counter() - t0
    for r in reqs:
        _check(not r.result.stop_reason.startswith("error"),
               f"batched request failed: {r.result.stop_reason}")
    return [r.result for r in reqs], secs


def _same_or_near_tie(single: Engine, prompt, got, want, what) -> None:
    """got == want, or equal up to a step where the single-stream logits of
    the two picks lie within NEAR_TIE (printed)."""
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    _check(i is not None, f"{what}: one reply stopped early: {got} {want}")
    single.reset_context()
    lg = single.eval_tokens(list(prompt) + got[:i], 0).float()
    a, b = lg[got[i]].item(), lg[want[i]].item()
    _check(abs(a - b) <= NEAR_TIE,
           f"{what}: tokens part at step {i} ({got[i]} vs {want[i]}), "
           f"single-stream logits {a} vs {b}")
    print(f"near-tie: {what}, step {i}: tokens {got[i]} / {want[i]}, "
          f"single-stream logits {a:.6f} / {b:.6f}", flush=True)


# greedy tokens of each batched request of phase_batched_serving (a
# batched step pays its host time per token)
BATCH_DEPTH = 16


def phase_batched_serving(card: str) -> dict:
    model = synthetic_model(TINYLLAMA_1_1B, "q4_k", seed=0, device=DEV)
    rng = np.random.default_rng(2)
    prompts = [[1] + rng.integers(3, 32000, size=int(n) - 1).tolist()
               for n in rng.integers(100, 301, size=8)]
    greedy = GenParams(max_length=BATCH_DEPTH, bypass_eos=True,
                       sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    stoch = GenParams(max_length=BATCH_DEPTH, bypass_eos=True, sampler=SamplerParams(
        temperature=0.8, top_p=0.9, top_k=60, rep_pen=1.05))
    single = Engine(model, max_context=2048, device=DEV)
    want = []
    for p in prompts:
        single.reset_context()
        want.append(single.generate(p, greedy).tokens)
    counts: dict = {}
    got = {}
    for paged in (False, True):
        kind = "paged P=64" if paged else "slot cache"
        eng = batch_engine.BatchedEngine(model, max_context=2048, n_slots=8,
                                         paged=paged, page_size=64,
                                         device=DEV)
        try:
            eng.generate([1, 2, 3, 4], GenParams(max_length=4,
                                                 sampler=greedy.sampler))
            eng.reset_context()
            _build.launches.clear()
            res, secs = _serve_together(eng, prompts, [greedy] * 8)
            for k, v in _build.launches.items():
                counts[k] = counts.get(k, 0) + v
            got[paged] = [r.tokens for r in res]
            for i, (p, r) in enumerate(zip(prompts, res)):
                _check(len(r.tokens) == BATCH_DEPTH, f"{kind} request {i}: {r}")
                _same_or_near_tie(single, p, r.tokens, want[i],
                                  f"{kind} request {i}")
            n = sum(len(r.tokens) for r in res)
            print(f"batched 1.1B ({kind}, {card}): 8 greedy requests, "
                  f"{n} tokens in {secs * 1e3:.1f} ms = {n / secs:.1f} "
                  f"tok/s aggregate (prefill of {sum(map(len, prompts))} "
                  f"prompt tokens included); launches "
                  f"{dict(_build.launches)}", flush=True)
            eng.reset_context()
            _build.launches.clear()
            res, secs = _serve_together(eng, prompts, [greedy] * 7 + [stoch])
            for k, v in _build.launches.items():
                counts[k] = counts.get(k, 0) + v
            _check([r.tokens for r in res[:7]] == got[paged][:7],
                   f"{kind}: greedy slots changed beside a stochastic one")
            _check(len(res[7].tokens) == BATCH_DEPTH
                   and all(0 <= t < 32000 for t in res[7].tokens),
                   f"{kind}: bad stochastic reply {res[7].tokens}")
            n = sum(len(r.tokens) for r in res)
            print(f"batched 1.1B ({kind}, {card}): 7 greedy + 1 stochastic "
                  f"request, {n} tokens in {secs * 1e3:.1f} ms = "
                  f"{n / secs:.1f} tok/s aggregate", flush=True)
        finally:
            eng.shutdown()
    _check(got[True] == got[False], "paged tokens differ from slot tokens")
    for k in ("K7", "K8", "K5", "K3"):
        _check(counts.get(k, 0) > 0, f"{k} did not run in batched serving")
    print(f"batched serving: paged tokens equal slot tokens; launches "
          f"{counts}", flush=True)
    del single
    # the quantized pools (--multiuser 8 --quantkv 1, --quantkv 2 --paged):
    # 8 concurrent requests, each getting the tokens it gets alone
    short = GenParams(max_length=BATCH_DEPTH, bypass_eos=True, sampler=greedy.sampler)
    for quantkv, kid in ((1, "K9"), (2, "K10")):
        kind = f"paged P=64, quantkv={quantkv}"
        eng = batch_engine.BatchedEngine(model, max_context=2048, n_slots=8,
                                         paged=True, page_size=64,
                                         device=DEV, quantkv=quantkv)
        try:
            eng.generate([1, 2, 3, 4], GenParams(max_length=4,
                                                 sampler=greedy.sampler))
            eng.reset_context()
            _build.launches.clear()
            res, secs = _serve_together(eng, prompts, [short] * 8)
            q_counts = dict(_build.launches)
            alone = []
            for p in prompts:
                eng.reset_context()
                alone.append(eng.generate(p, short).tokens)
        finally:
            eng.shutdown()
        ref = Engine(model, max_context=2048, device=DEV, quantkv=quantkv)
        for i, (p, r) in enumerate(zip(prompts, res)):
            _check(len(r.tokens) == BATCH_DEPTH, f"{kind} request {i}: {r}")
            _same_or_near_tie(ref, p, r.tokens, alone[i],
                              f"{kind} request {i} (together vs alone)")
        del ref
        _check(q_counts.get(kid, 0) > 0,
               f"{kid} did not run under {kind}: {q_counts}")
        n = sum(len(r.tokens) for r in res)
        print(f"batched 1.1B ({kind}, {card}): 8 greedy requests, {n} "
              f"tokens in {secs * 1e3:.1f} ms = {n / secs:.1f} tok/s "
              f"aggregate (prefill included); each equals its reply alone; "
              f"launches {q_counts}", flush=True)
        for k, v in q_counts.items():
            counts[k] = counts.get(k, 0) + v
    del model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the opt-in decode kernels: KCPP_FFN_FUSED=1 (K15) and KCPP_SBQ=1 (K14)
# ---------------------------------------------------------------------------

def _env(**kv):
    """The environment with kv set for a block, restored after it; the
    JAX package and the port read "0" as off."""
    return mock.patch.dict(os.environ, kv)


class _StepLaunches:
    """The launches of each forward of a run, by the forward's token shape
    (B, T): wraps models.llama.forward / forward_paged / forward_stacked
    and models.deepseek2.forward, which the engines and the scan phase
    call through the module, and takes the launch counters' difference
    over each call (the wrappers count on the calling thread)."""

    def __enter__(self):
        self.by_shape: dict = {}
        self.orig = (llama.forward, llama.forward_paged,
                     llama.forward_stacked, ds2.forward)

        def wrap(fn):
            def forward(params, cfg, tokens, *a, **k):
                before = dict(_build.launches)
                out = fn(params, cfg, tokens, *a, **k)
                delta = {n: c - before.get(n, 0)
                         for n, c in _build.launches.items()
                         if c != before.get(n, 0)}
                self.by_shape.setdefault(tuple(tokens.shape), []).append(
                    delta)
                return out
            return forward

        (llama.forward, llama.forward_paged, llama.forward_stacked,
         ds2.forward) = map(wrap, self.orig)
        return self

    def __exit__(self, *exc):
        (llama.forward, llama.forward_paged, llama.forward_stacked,
         ds2.forward) = self.orig

    def steps(self, B: int) -> list[dict]:
        """The launches of each decode step of B sequences."""
        return self.by_shape.get((B, 1), [])


def _check_steps(rec: _StepLaunches, B: int, want: dict, what: str) -> int:
    """Every decode step of B sequences launched exactly `want` (ids with
    0: none). Returns the number of steps."""
    steps = rec.steps(B)
    _check(len(steps) > 0, f"{what}: no decode step of {B} sequences")
    for d in steps:
        _check(all(d.get(k, 0) == n for k, n in want.items()),
               f"{what}: a decode step launched {d}, want {want}")
    return len(steps)


FUSED_DEPTH = 32  # greedy tokens of the fused single-stream phase
OPT_IN_DEPTH = 8  # greedy tokens per request of the opt-in batched phases


def phase_fused_single(card: str, model, bf16_tps: float) -> dict:
    """The synthetic 1.1B q4_k single-stream under KCPP_FFN_FUSED=1: the
    300-token prompt and FUSED_DEPTH greedy tokens, every decode step with
    22 K15b (one per layer's FFN) and 45 K1 (wqkv and wo per layer, the
    output), against the unfused phase's 89 K1; a fast-forwarded repeat
    gives the same tokens (near-ties apart); the logits of the prompt's
    last token, evaluated as a decode step, against the unfused forward's
    on the same cache."""
    gp = GenParams(max_length=FUSED_DEPTH, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    prompt = [1] + np.random.default_rng(1).integers(
        3, 32000, size=299).tolist()
    with _env(KCPP_FFN_FUSED="1", KCPP_SBQ="0"):
        eng = Engine(model, max_context=2048, device=DEV)
        eng.generate(prompt[:40], GenParams(max_length=8, bypass_eos=True,
                                            sampler=gp.sampler))
        eng.reset_context()
        _build.launches.clear()
        with _StepLaunches() as rec:
            r1 = eng.generate(prompt, gp)
            t1 = eng.last_timings
            r2 = eng.generate(prompt, gp)
        counts = dict(_build.launches)
        L = TINYLLAMA_1_1B.n_layers
        n = _check_steps(rec, 1, {"K15b": L, "K1": 2 * L + 1, "K7": 0,
                                  "K3": 0}, "fused single-stream")
        _check(len(r1.tokens) == FUSED_DEPTH
               and all(0 <= t < 32000 for t in r1.tokens),
               f"fused: bad reply {r1.tokens}")
        _check(eng.last_timings.prompt_tokens == 1, "fused: no fast-forward")
        _same_or_near_tie(eng, prompt, r2.tokens, r1.tokens,
                          "fused single-stream repeat")
        # the prompt's last token as a decode step (T=1: K15b), then the
        # same step unfused, over the same cache rows
        eng.reset_context()
        tok = torch.tensor([[prompt[-1]]], dtype=torch.int64, device=DEV)
        pos = torch.tensor([[299]], dtype=torch.int64, device=DEV)
        with torch.inference_mode():
            eng.eval_tokens(prompt[:-1], 0)
            fused = eng._forward(tok, pos, last_only=True)[0, -1].float()
            with _env(KCPP_FFN_FUSED="0"):
                plain = eng._forward(tok, pos, last_only=True)[0, -1].float()
        eng.reset_context()
        eng.generate(prompt, gp)
        # fast-forwarded requests decoding FUSED_DEPTH tokens, unfused and
        # fused in turns on the same engine
        turns: dict = {"0": [], "1": []}
        for on in ("0", "1", "1", "0"):
            with _env(KCPP_FFN_FUSED=on):
                eng.generate(prompt, gp)
            turns[on].append(round(eng.last_timings.gen_tps, 1))
    _check(fused.shape == (32000,) and bool(torch.isfinite(fused).all()),
           "fused logits are not finite (32000,)")
    # the fused FFN takes bf16 x and f32 gate/up where the unfused one
    # takes int8 activations per 32 columns (K1) and bf16 gate/up: over 22
    # layers the logits part by that rounding, 0.45% of max |logit| on the
    # H100, not by a bug (a wrong row or phase moves them by O(max |logit|))
    err = (fused - plain).abs().max().item()
    tol = 2e-2 * plain.abs().max().item()
    _check(err <= tol, f"fused logits {err} from the unfused ones > {tol}")
    print(f"end to end, KCPP_FFN_FUSED=1 ({card}): prefill "
          f"{t1.prompt_tokens} tokens {t1.prompt_time * 1e3:.1f} ms, decode "
          f"{t1.gen_tokens} tokens {t1.gen_tps:.1f} tok/s (unfused in this "
          f"run: {bf16_tps:.1f} tok/s); {n} decode steps of {L} K15b + "
          f"{2 * L + 1} K1 (unfused: {4 * L + 1} K1); last-token logits vs "
          f"unfused: max abs err "
          f"{err:.4g} (tol {tol:.4g}, max |logit| "
          f"{plain.abs().max().item():.4g}); launches {counts}", flush=True)
    print(f"decode tok/s of fast-forwarded requests in turns: unfused "
          f"{turns['0']}, KCPP_FFN_FUSED=1 {turns['1']}", flush=True)
    del eng
    return counts


def _serve_alone_and_together(model, n_slots: int, prompts, gp, want: dict,
                              kind: str, card: str,
                              turns_env: str | None = None) -> dict:
    """len(prompts) concurrent greedy requests through BatchedEngine
    (n_slots, slot cache): every decode step launches `want`, and each
    request gets the tokens it gets alone through the same engine
    (near-ties apart, read on a single-stream Engine under the same
    environment). turns_env: then time the same requests, fast-forwarded,
    with that variable off and on in turns. Returns the launch counts of
    the concurrent run."""
    eng = batch_engine.BatchedEngine(model, max_context=2048,
                                     n_slots=n_slots, device=DEV)
    try:
        eng.generate([1, 2, 3, 4], GenParams(max_length=4,
                                             sampler=gp.sampler))
        eng.reset_context()
        _build.launches.clear()
        with _StepLaunches() as rec:
            res, secs = _serve_together(eng, prompts, [gp] * len(prompts))
        counts = dict(_build.launches)
        n = _check_steps(rec, n_slots, want, kind)
        alone = []
        for p in prompts:
            eng.reset_context()
            alone.append(eng.generate(p, gp).tokens)
        turns: dict = {"0": [], "1": []}
        if turns_env:
            _serve_together(eng, prompts, [gp] * len(prompts))
            for on in ("0", "1", "1", "0"):
                with _env(**{turns_env: on}):
                    out, t = _serve_together(eng, prompts,
                                             [gp] * len(prompts))
                turns[on].append(round(sum(len(r.tokens) for r in out)
                                       / t, 1))
    finally:
        eng.shutdown()
    ref = Engine(model, max_context=2048, device=DEV)
    for i, (p, r) in enumerate(zip(prompts, res)):
        _check(len(r.tokens) == gp.max_length, f"{kind} request {i}: {r}")
        _same_or_near_tie(ref, p, r.tokens, alone[i],
                          f"{kind} request {i} (together vs alone)")
    del ref
    tokens = sum(len(r.tokens) for r in res)
    print(f"batched 1.1B ({kind}, {card}): {len(prompts)} greedy requests, "
          f"{tokens} tokens in {secs * 1e3:.1f} ms = {tokens / secs:.1f} "
          f"tok/s aggregate (prefill of {sum(map(len, prompts))} prompt "
          f"tokens included); {n} decode steps of {want}; each equals its "
          f"reply alone; launches {counts}", flush=True)
    if turns_env:
        print(f"aggregate tok/s of the same requests fast-forwarded, in "
              f"turns: {turns_env}=0 {turns['0']}, {turns_env}=1 "
              f"{turns['1']}", flush=True)
    return counts


def phase_opt_in_batched(card: str, model) -> dict:
    """The synthetic 1.1B q4_k batched: 8 slots under KCPP_FFN_FUSED=1
    (every decode step 22 K15a and 45 K7), then 16 slots under KCPP_SBQ=1
    (every decode step 89 K14: each projection, no K7, no K3, the FFN
    declining K15 at 16 tokens), 8 and 16 concurrent greedy requests of
    100-300 prompt tokens and OPT_IN_DEPTH new tokens each; each set then
    timed with its variable off and on in turns (off: K7 and the composed
    FFN at 8 slots, K3 at 16)."""
    rng = np.random.default_rng(3)
    prompts = [[1] + rng.integers(3, 32000, size=int(n) - 1).tolist()
               for n in rng.integers(100, 301, size=16)]
    gp = GenParams(max_length=OPT_IN_DEPTH, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    counts: dict = {}
    L = TINYLLAMA_1_1B.n_layers
    with _env(KCPP_FFN_FUSED="1", KCPP_SBQ="0"):
        c = _serve_alone_and_together(
            model, 8, prompts[:8], gp,
            {"K15a": L, "K7": 2 * L + 1, "K3": 0, "K14": 0},
            "8 slots, KCPP_FFN_FUSED=1", card, "KCPP_FFN_FUSED")
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    with _env(KCPP_SBQ="1", KCPP_FFN_FUSED="0"):
        c = _serve_alone_and_together(
            model, 16, prompts, gp, {"K14": 4 * L + 1, "K7": 0, "K3": 0},
            "16 slots, KCPP_SBQ=1", card, "KCPP_SBQ")
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    return counts


# kind of the synthetic 1.1B -> (greedy tokens single-stream, per batched
# request; the bodies that must run single-stream, batched; whether a
# batched request is held to its single-stream tokens (q5_k: T=1 and T>=2
# share their arithmetic) or to the tokens it gets alone through the
# batched engine (q6_k, q8_0, q2_k, q3_k: int8 activations at T=1 against
# the tiled bf16 product at T>=2, as the JAX dispatch is built)). Every kind
# runs at 32 greedy tokens single-stream (q6_k, added last: 16; one device
# chunk computes 32 either way) and 8 per batched request (the batched
# engine's host loop: a step a token), to keep the script within its time
# budget.
# (kind, single-stream tokens, tokens of each of the 8 batched requests (a
# batched step pays its host time per token), kernels single-stream,
# kernels batched, batched held to single-stream)
NEW_KINDS = (
    ("q6_k", 16, 4, ("K2", "K3"), ("K3",), False),
    ("q5_k", 32, 4, ("K1.q5_k", "K3.q5_k"), ("K7.q5_k",), True),
    ("q8_0", 32, 4, ("K2.q8_0", "K3.q8_0"), ("K3.q8_0",), False),
    ("q2_k", 32, 4, ("K12.q2_k", "K13.q2_k"), ("K13.q2_k",), False),
    ("q3_k", 32, 4, ("K12.q3_k", "K13.q3_k"), ("K13.q3_k",), False),
    ("iq2p", 32, 4, ("K12.iq2p", "K13.iq2p"), ("K13.iq2p",), False),
    ("iq3px", 32, 4, ("K12.iq3px", "K13.iq3px"), ("K13.iq3px",), False),
    ("iq3ps", 32, 4, ("K12.iq3ps", "K13.iq3ps"), ("K13.iq3ps",), False),
    ("iq1p", 32, 4, ("K12.iq1p", "K13.iq1p"), ("K13.iq1p",), False))


def phase_new_kinds(card: str) -> dict:
    """The synthetic 1.1B with q6_k, q5_k, q8_0, q2_k, q3_k and the IQ
    kinds' weights (NEW_KINDS):
    single-stream through Engine on the bf16 cache (a 300-token prompt,
    greedy tokens, the same prompt again: fast-forward, the same tokens
    near-ties apart; q6_k: every decode step 89 K2; q6_k, q2_k, q3_k: 8
    more tokens under KCPP_MM_I8=0, every decode step 89 of the T=1 body's
    bf16-x variant), then 8 concurrent greedy requests of 100-300 prompt
    tokens through BatchedEngine (8 slots, slot cache), each getting its
    single-stream tokens (q5_k) or the tokens it gets alone through the
    same batched engine (the other kinds). Near-ties allowed, as in
    phase 4."""
    rng = np.random.default_rng(1)
    prompt = [1] + rng.integers(3, 32000, size=299).tolist()
    rng = np.random.default_rng(2)
    prompts = [[1] + rng.integers(3, 32000, size=int(n) - 1).tolist()
               for n in rng.integers(100, 301, size=8)]
    sampler = SamplerParams(temperature=0.0, rep_pen=1.0)
    counts: dict = {}
    cfg = TINYLLAMA_1_1B
    for kind, n1, n8, need_single, need_batched, vs_single in NEW_KINDS:
        g1 = GenParams(max_length=n1, bypass_eos=True, sampler=sampler)
        g8 = GenParams(max_length=n8, bypass_eos=True, sampler=sampler)
        g0 = GenParams(max_length=8, bypass_eos=True, sampler=sampler)
        t0 = time.perf_counter()
        model = synthetic_model(cfg, kind, seed=0, device=DEV)
        build_s = time.perf_counter() - t0
        single = Engine(model, max_context=2048, device=DEV)
        single.generate(prompt[:40], GenParams(max_length=40, bypass_eos=True,
                                               sampler=sampler))
        single.reset_context()
        _build.launches.clear()
        with _StepLaunches() as rec:
            r1 = single.generate(prompt, g1)
            t1 = single.last_timings
            r2 = single.generate(prompt, g1)
        c1 = dict(_build.launches)
        # the T=1 body's launches per decode step (89: 22 layers x 4 and
        # the head, every weight of the kind); held for q6_k (K2)
        t1_kid = need_single[0]
        per_step = sorted({d.get(t1_kid, 0) for d in rec.steps(1)})
        if kind == "q6_k":
            _check_steps(rec, 1, {"K2": 4 * cfg.n_layers + 1},
                         "q6_k single-stream")
        _check(len(r1.tokens) == n1 and all(0 <= t < 32000 for t in r1.tokens),
               f"{kind}: bad reply {r1.tokens}")
        _check(t1.prompt_tokens == 300
               and single.last_timings.prompt_tokens == 1,
               f"{kind}: no fast-forward ({t1}, {single.last_timings})")
        for k in need_single:
            _check(c1.get(k, 0) > 0,
                   f"{k} did not run single-stream on {kind}: {c1}")
        with torch.inference_mode():
            logits = single._eval_chunk([5], len(single.context_tokens))
        _check(logits.shape == (32000,) and bool(torch.isfinite(logits).all()),
               f"{kind}: logits are not finite (32000,)")
        # the repeat re-evaluates the last prompt token through the plain
        # attention (the first request's prefill ran K4): the same tokens,
        # near-ties apart
        _same_or_near_tie(single, prompt, r2.tokens, r1.tokens,
                          f"{kind} fast-forward repeat")
        print(f"end to end, synthetic TinyLlama-1.1B {kind} ({card}; weights "
              f"built in {build_s:.1f} s): prefill {t1.prompt_tokens} tokens "
              f"{t1.prompt_time * 1e3:.1f} ms, decode {t1.gen_tokens} tokens "
              f"{t1.gen_tps:.1f} tok/s; fast-forward repeat 1 prompt token; "
              f"{t1_kid} per decode step {per_step}; launches {c1}",
              flush=True)
        c0: dict = {}
        if kind in qm.ROWMV_KINDS:
            # the bf16-x body on the main path: under KCPP_MM_I8=0 every
            # decode step runs 89 of it (the same counter as the int8 one)
            before = dict(_build.launches)
            with _env(KCPP_MM_I8="0"), _StepLaunches() as rec0:
                r0 = single.generate(prompt, g0)
            c0 = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                  if v != before.get(k, 0)}
            n0 = _check_steps(rec0, 1, {t1_kid: 4 * cfg.n_layers + 1},
                              f"{kind} KCPP_MM_I8=0")
            _check(len(r0.tokens) == g0.max_length
                   and all(0 <= t < 32000 for t in r0.tokens),
                   f"{kind} KCPP_MM_I8=0: bad reply {r0.tokens}")
            print(f"{kind} single-stream under KCPP_MM_I8=0 ({card}): {n0} "
                  f"decode steps of {4 * cfg.n_layers + 1} "
                  f"{t1_kid} (the bf16-x body); launches {c0}", flush=True)

        eng = batch_engine.BatchedEngine(model, max_context=2048, n_slots=8,
                                         device=DEV)
        try:
            eng.generate([1, 2, 3, 4], GenParams(max_length=4,
                                                 sampler=sampler))
            eng.reset_context()
            _build.launches.clear()
            res, secs = _serve_together(eng, prompts, [g8] * 8)
            c2 = dict(_build.launches)
            if not vs_single:
                want = []
                for p in prompts:
                    eng.reset_context()
                    want.append(eng.generate(p, g8).tokens)
        finally:
            eng.shutdown()
        if vs_single:
            want = []
            for p in prompts:
                single.reset_context()
                want.append(single.generate(p, g8).tokens)
        ref = "single-stream" if vs_single else "alone"
        for i, (p, r) in enumerate(zip(prompts, res)):
            _check(len(r.tokens) == n8, f"{kind} batched request {i}: {r}")
            _same_or_near_tie(single, p, r.tokens, want[i],
                              f"{kind} batched request {i} ("
                              + ("single-stream" if vs_single
                                 else "alone through the batched engine")
                              + ")")
        for k in need_batched:
            _check(c2.get(k, 0) > 0,
                   f"{k} did not run in batched serving on {kind}: {c2}")
        n = sum(len(r.tokens) for r in res)
        print(f"batched 1.1B {kind} (slot cache, {card}): 8 greedy requests, "
              f"{n} tokens in {secs * 1e3:.1f} ms = {n / secs:.1f} tok/s "
              f"aggregate (prefill of {sum(map(len, prompts))} prompt tokens "
              f"included); each equals its reply {ref}; launches {c2}",
              flush=True)
        if kind == "q5_k":
            # K14's q5_k body on the main path: the same 8 requests (8 new
            # tokens each) under KCPP_SBQ=1, 89 K14.q5_k per decode step
            with _env(KCPP_SBQ="1", KCPP_FFN_FUSED="0"):
                c3 = _serve_alone_and_together(
                    model, 8, prompts,
                    GenParams(max_length=8, bypass_eos=True, sampler=sampler),
                    {"K14.q5_k": 4 * cfg.n_layers + 1,
                     "K7.q5_k": 0, "K3.q5_k": 0},
                    "q5_k 8 slots, KCPP_SBQ=1", card)
            for k, v in c3.items():
                counts[k] = counts.get(k, 0) + v
        for c in (c1, c0, c2):
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        del single, model
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the opt-in layouts on the synthetic 1.1B: KCPP_KQ_LAYOUT=expanded,
# KCPP_Q4K_LAYOUT=i8, KCPP_MM_I8=0
# ---------------------------------------------------------------------------

# (label, the default kind, its relayout (None: the same weights), the
# variables of the run, the new T=1 body, the body it replaces there)
OPT_IN_LAYOUTS = (
    ("q6_k_i8f", "q6_k", to_expanded, {"KCPP_KQ_LAYOUT": "expanded"},
     "K12.q6_k_i8f", "K2"),
    ("q3_k_n4", "q3_k", to_expanded, {"KCPP_KQ_LAYOUT": "expanded"},
     "K12.q3_k_n4", "K12.q3_k"),
    ("q2_k_n4", "q2_k", to_expanded, {"KCPP_KQ_LAYOUT": "expanded"},
     "K12.q2_k_n4", "K12.q2_k"),
    ("q4_k_i8", "q4_k", to_q4_k_i8, {"KCPP_Q4K_LAYOUT": "i8"},
     "K13.q4_k_i8", "K1"),
    ("q8_0, bf16 x", "q8_0", None, {"KCPP_MM_I8": "0"}, "K2.q8_0_bf16",
     "K2.q8_0"))
OPT_IN_LAYOUT_DEPTH = 16  # greedy tokens of each single-stream run
# the last prompt token's logits against the default layout's, as a share
# of max |logit|: 2e-2 (PR 7's bound for the fused FFN); 4e-2
# (tests/test_torch_lowbit.py's bound for a model that amplifies rounding)
# for q6_k_i8f, whose T=1 function is not the default's in the JAX package
# either (q6_k folds -32 s bf16(sum x) where q6_k_i8f dots q6 - 32: 1.1%
# rms apart per projection at in_f 2048, in both packages alike,
# tests/test_torch_opt_in_layouts.py::test_expanded_layout_gap_is_jax_own;
# 2.29% of max |logit| after 22 layers on the H100), and for any layout
# whose model is shown to amplify rounding: the default layout's logits
# move by more than 1e-2 of max |logit| when 1% of the token's bf16
# embedding entries move one step (the premise test_torch_lowbit.py
# asserts for its 4e-2; q3_k_n4 and q3_k run the same arithmetic up to
# the f32 summation order, yet their logits part by 2.97% on the H100)
OPT_IN_LOGIT_TOL = {"q6_k_i8f": 4e-2}
AMPLIFIED_LOGIT_TOL = 4e-2


def _embedding_nudged(params, tok: int):
    """params with 1% of token tok's bf16 embedding entries one step up
    (a fixed draw)."""
    emb = params["tok_embd"]
    w = emb.data["w"].clone()
    cols = torch.randperm(w.shape[1], generator=torch.Generator().manual_seed(
        0))[:w.shape[1] // 100].to(w.device)
    w.view(torch.int16)[tok, cols] += 1
    return dict(params, tok_embd=QTensor(emb.kind, emb.shape, {"w": w}))
# the variables at their defaults, for the runs of the default layout
_DEFAULTS = {"KCPP_KQ_LAYOUT": "dense", "KCPP_Q4K_LAYOUT": "packed",
             "KCPP_MM_I8": "1"}


def _relayout(model, kind: str, fn):
    """model with every packed weight of `kind` through fn (the opt-in
    layout of the same values; the tensors the two share are not
    copied)."""
    def conv(v):
        return fn(v) if isinstance(v, QTensor) and v.kind == kind else v
    params = dict(model.params, output=conv(model.params["output"]),
                  layers=[{k: conv(v) for k, v in layer.items()}
                          for layer in model.params["layers"]])
    return Model(model.cfg, params, model.tokenizer, model.device)


def phase_opt_in_layouts(card: str, q4k_model) -> dict:
    """The synthetic 1.1B (full width, 22 layers) in each opt-in layout of
    OPT_IN_LAYOUTS, single-stream under its variables: the 300-token prompt
    and OPT_IN_LAYOUT_DEPTH greedy tokens, every decode step 89 launches of
    the new T=1 body and none of the body it replaces (q4_k_i8: 89
    K13.q4_k_i8, no K1, and every prefill chunk through K13.q4_k_i8, no
    K3); a fast-forwarded repeat gives the same tokens (near-ties apart);
    the logits of the prompt's last token, evaluated as a decode step,
    within 2e-2 of max |logit| (4e-2 for q6_k_i8f and where the model
    amplifies rounding: OPT_IN_LOGIT_TOL) of the same weights in the
    default layout (the default variables) over the same cache; the
    default layout's
    decode tok/s in the same run. Then q4_k_i8, the one layout whose T>1
    path is new, with 8 slots: 8 concurrent requests of 8 tokens, each
    getting the tokens it gets alone."""
    gp = GenParams(max_length=OPT_IN_LAYOUT_DEPTH, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    warm = GenParams(max_length=8, bypass_eos=True, sampler=gp.sampler)
    prompt = [1] + np.random.default_rng(1).integers(
        3, 32000, size=299).tolist()
    tok = torch.tensor([[prompt[-1]]], dtype=torch.int64, device=DEV)
    pos = torch.tensor([[299]], dtype=torch.int64, device=DEV)
    L = TINYLLAMA_1_1B.n_layers
    counts: dict = {}
    far: list = []
    for label, kind, fn, env, new_kid, old_kid in OPT_IN_LAYOUTS:
        t0 = time.perf_counter()
        base = (q4k_model if kind == "q4_k" else
                synthetic_model(TINYLLAMA_1_1B, kind, seed=0, device=DEV))
        model = _relayout(base, kind, fn) if fn else base
        build_s = time.perf_counter() - t0
        with _env(**env):
            eng = Engine(model, max_context=2048, device=DEV)
            eng.generate(prompt[:40], warm)
            eng.reset_context()
            _build.launches.clear()
            with _StepLaunches() as rec:
                r1 = eng.generate(prompt, gp)
                t1 = eng.last_timings
                r2 = eng.generate(prompt, gp)
            c = dict(_build.launches)
            n = _check_steps(rec, 1, {new_kid: 4 * L + 1, old_kid: 0},
                             f"{label} single-stream")
            if kind == "q4_k":
                chunks = [d for (B, T), ds in rec.by_shape.items() if T > 1
                          for d in ds]
                _check(chunks and all(d.get("K13.q4_k_i8", 0) > 0
                                      and not d.get("K3") and not d.get("K1")
                                      for d in chunks),
                       f"q4_k_i8 prefill chunks launched {chunks}")
            _check(len(r1.tokens) == OPT_IN_LAYOUT_DEPTH
                   and all(0 <= t < 32000 for t in r1.tokens),
                   f"{label}: bad reply {r1.tokens}")
            _check(eng.last_timings.prompt_tokens == 1,
                   f"{label}: no fast-forward")
            _same_or_near_tie(eng, prompt, r2.tokens, r1.tokens,
                              f"{label} fast-forward repeat")
            eng.reset_context()
            with torch.inference_mode():
                eng.eval_tokens(prompt[:-1], 0)
                got = eng._forward(tok, pos, last_only=True)[0, -1].float()
                with _env(**{k: _DEFAULTS[k] for k in env}):
                    want = llama.forward(base.params, TINYLLAMA_1_1B, tok,
                                         pos, eng.cache, last_only=True)[0]
                    moved = llama.forward(
                        _embedding_nudged(base.params, prompt[-1]),
                        TINYLLAMA_1_1B, tok, pos, eng.cache,
                        last_only=True)[0]
                want = want[0, -1].float()
                moved = moved[0, -1].float()
        del eng
        _check(got.shape == (32000,) and bool(torch.isfinite(got).all()),
               f"{label}: logits are not finite (32000,)")
        # the opt-in bodies round otherwise (bf16(q*s) tiles and bf16 x
        # where K1 reads int8 x per 32, bf16 x where K2.q8_0 reads int8,
        # q6 - 32 where K2 folds the offset; see OPT_IN_LOGIT_TOL): over
        # 22 layers the logits part by that rounding, as the fused FFN's
        # did (PR 7)
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        spread = (moved - want).abs().max().item() / top
        tol = (AMPLIFIED_LOGIT_TOL if spread > 1e-2
               else OPT_IN_LOGIT_TOL.get(label, 2e-2)) * top
        if err > tol:  # checked after every layout has run
            far.append(f"{label} logits {err} from the default layout's "
                       f"> {tol}")
        with _env(**{k: _DEFAULTS[k] for k in env}):
            ref = Engine(base, max_context=2048, device=DEV)
            ref.generate(prompt[:40], warm)
            ref.reset_context()
            ref.generate(prompt, gp)
            default_tps = ref.last_timings.gen_tps
        del ref
        print(f"end to end, synthetic TinyLlama-1.1B {label} under {env} "
              f"({card}; weights built in {build_s:.1f} s): prefill "
              f"{t1.prompt_tokens} tokens {t1.prompt_time * 1e3:.1f} ms, "
              f"decode {t1.gen_tokens} tokens {t1.gen_tps:.1f} tok/s "
              f"(default layout in this run: {default_tps:.1f} tok/s); "
              f"{n} decode steps of {4 * L + 1} {new_kid}, no {old_kid}; "
              f"last-token logits vs the default layout: max abs err "
              f"{err:.4g} (tol {tol:.4g}, max |logit| {top:.4g}; the "
              f"default layout moved by {spread:.4g} of it with 1% of the "
              f"token's embedding one bf16 step off); launches {c}",
              flush=True)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        if kind == "q4_k":
            rng = np.random.default_rng(2)
            prompts = [[1] + rng.integers(3, 32000, size=int(m) - 1).tolist()
                       for m in rng.integers(100, 301, size=8)]
            with _env(**env):
                c = _serve_alone_and_together(
                    model, 8, prompts,
                    GenParams(max_length=8, bypass_eos=True,
                              sampler=gp.sampler),
                    {"K13.q4_k_i8": 4 * L + 1, "K7": 0, "K3": 0},
                    "q4_k_i8 8 slots, KCPP_Q4K_LAYOUT=i8", card)
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        del model, base
        torch.cuda.empty_cache()
    _check(not far, "; ".join(far))
    return counts


# ---------------------------------------------------------------------------
# the scan decode path: layer-stacked weights over a pooled cache
# ---------------------------------------------------------------------------

SCAN_DEPTH = 32  # greedy tokens of the q4_k scan phase
SCAN_Q8_DEPTH = 16  # ... and of the q8_0 one


def _greedy_run(fwd, params, cache, prompt: list[int], n: int):
    """The prompt as one prefill chunk, then n greedy single-token steps
    (the argmax stays on the card). Returns (tokens, the logits each token
    was picked from (n, V) f32, decode seconds)."""
    cfg = TINYLLAMA_1_1B
    with torch.inference_mode():
        lg, cache = fwd(params, cfg, torch.tensor([prompt], device=DEV),
                        torch.arange(len(prompt), device=DEV)[None], cache,
                        last_only=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, rows = [], []
        for i in range(n):
            rows.append(lg[0, -1].float())
            nxt = lg[:, -1].argmax(dim=-1, keepdim=True)
            toks.append(nxt)
            if i + 1 < n:
                lg, cache = fwd(params, cfg, nxt, torch.full(
                    (1, 1), len(prompt) + i, device=DEV), cache,
                    last_only=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return torch.cat(toks, 1)[0].tolist(), torch.stack(rows), secs


def _scan_vs_unrolled(card: str, params, kind: str, n: int, want: dict,
                      prefill_kid: str) -> dict:
    """`forward_stacked` over a pooled cache against `forward` over the
    slot cache on the same weights: the prompt of phase 3 as one prefill
    chunk (through prefill_kid, not K4), n greedy tokens that must agree
    (a step where they part must be a near-tie of the scan's logits,
    printed), every scan decode step launching exactly `want`; then the
    decode tok/s of both in turns. Returns the scan runs' launches."""
    cfg, L = TINYLLAMA_1_1B, TINYLLAMA_1_1B.n_layers
    prompt = [1] + np.random.default_rng(1).integers(
        3, 32000, size=299).tolist()
    shape = (L, 1, 2048, cfg.n_kv_heads, cfg.head_dim)
    sparams = llama.stack_layers(params)
    _check("layers_stacked" in sparams, f"{kind}: the layers did not stack")

    def scan(n_tok):
        return _greedy_run(llama.forward_stacked, sparams,
                           init_pool_cache(*shape, device=DEV), prompt,
                           n_tok)

    def unrolled(n_tok):
        return _greedy_run(llama.forward, params,
                           init_cache(*shape, device=DEV), prompt, n_tok)

    scan(2)
    want_toks, _, _ = unrolled(n)
    _build.launches.clear()
    with _StepLaunches() as rec:
        got, rows, _ = scan(n)
    counts = dict(_build.launches)
    steps = _check_steps(rec, 1, want, f"scan decode ({kind})")
    pre = rec.by_shape.get((1, len(prompt)), [])
    _check(len(pre) == 1 and pre[0].get(prefill_kid, 0) > 0
           and pre[0].get("K4", 0) == 0,
           f"scan prefill ({kind}) did not run {prefill_kid} without K4: "
           f"{pre}")
    if got != want_toks:
        i = next(j for j, (a, b) in enumerate(zip(got, want_toks)) if a != b)
        a, b = rows[i, got[i]].item(), rows[i, want_toks[i]].item()
        _check(abs(a - b) <= NEAR_TIE,
               f"scan decode ({kind}): tokens part from the unrolled ones "
               f"at step {i} ({got[i]} vs {want_toks[i]}), logits {a} / {b}")
        print(f"near-tie: scan decode ({kind}), step {i}: tokens {got[i]} / "
              f"{want_toks[i]}, scan logits {a:.6f} / {b:.6f}", flush=True)
    _check(bool(torch.isfinite(rows).all()) and rows.shape == (n, 32000),
           f"scan decode ({kind}): logits not finite (n, 32000)")
    tps: dict = {"scan": [], "unroll": []}
    for mode in ("unroll", "scan", "scan", "unroll"):
        _, _, secs = (scan if mode == "scan" else unrolled)(n)
        tps[mode].append(round(n / secs, 1))
    print(f"scan decode ({kind}, {L} layers stacked, pooled cache, {card}): "
          f"{n} greedy tokens equal to the unrolled forward's, {steps} decode "
          f"steps of {want}; prefill {pre[0]}; decode tok/s in turns: scan "
          f"{tps['scan']}, unrolled {tps['unroll']}", flush=True)
    del sparams
    torch.cuda.empty_cache()
    return counts


KV_DEPTH = 8    # greedy tokens of each kernel-variable request
KV_SLOTS = 12   # the batched run's slots under KCPP_MATVEC_MAX_T: T past 8
KV_CAP = 16     # its KCPP_MATVEC_MAX_T
# the kernel-selection variables at their defaults
KV_DEFAULTS = {"KCPP_Q4K_DECODE": "1", "KCPP_PALLAS_MM": "1",
               "KCPP_Q4K_2D": "sexp", "KCPP_Q4K_RAW_X": "1",
               "KCPP_Q4K_I8": "1", "KCPP_FLASH_DECODE": "1"}


def _k7_or_k3(model, T: int) -> tuple[int, int]:
    """(K7, K3) launches of a decode step of T sequences with bf16
    activations under KCPP_MATVEC_MAX_T >= T: a q4_k / q5_k weight that
    the JAX row-tile rule admits takes K7, every other packed one K3."""
    n7 = n3 = 0
    for w in [v for layer in model.params["layers"] for v in layer.values()
              ] + [model.params["output"]]:
        if not isinstance(w, QTensor) or w.kind == "dense":
            continue
        if w.kind in ("q4_k", "q5_k") and qm._q4k_matvec_rt(
                w.kind, *w.shape, T, False, False) is not None:
            n7 += 1
        elif w.kind in ("q4_k", "q6_k"):
            n3 += 1
    return n7, n3


def phase_kernel_vars(card: str, model) -> dict:
    """The launcher's kernel-selection variables on the synthetic 1.1B q4_k
    (full width, 22 layers), read where the JAX dispatch reads them. Each
    variable serves one single-stream request (a 300-token prompt and
    KV_DEPTH greedy tokens) with its route checked on every decode step:
    KCPP_Q4K_DECODE=0 and KCPP_PALLAS_MM=0 89 K3 (the swap form at T = 1)
    and no K1; KCPP_Q4K_2D=magic every prefill chunk through K3.q4_k_magic
    and no K3; KCPP_Q4K_RAW_X=0 under KCPP_Q4K_I8=0 89 K1 (its bf16 body);
    KCPP_FLASH_DECODE=0 22 K5 as without it. Then the logits of the
    prompt's last token, from the prefill chunk and evaluated as a decode
    step over the same cache, against the variables' defaults: within 2e-2
    of max |logit|, 4e-2 where the model amplifies rounding (the default's
    logits move by more than 1e-2 of it with 1% of the token's embedding
    one bf16 step off; OPT_IN_LOGIT_TOL's rule). Last KCPP_MATVEC_MAX_T=16
    with KCPP_Q4K_I8=0 over KV_SLOTS slots: every decode step K7's bf16
    body on the weights the JAX row-tile rule admits at T = 12, K3 on the
    rest (`_k7_or_k3`), two requests each getting its reply alone."""
    L = TINYLLAMA_1_1B.n_layers
    n_mv = 4 * L + 1
    prompt = [1] + np.random.default_rng(3).integers(
        3, 32000, size=299).tolist()
    sampler = SamplerParams(temperature=0.0, rep_pen=1.0)
    gp = GenParams(max_length=KV_DEPTH, bypass_eos=True, sampler=sampler)
    tok = torch.tensor([[prompt[-1]]], dtype=torch.int64, device=DEV)
    pos = torch.tensor([[299]], dtype=torch.int64, device=DEV)
    cases = (  # label, env, the compared run's env, a decode step, prefill
        ("KCPP_Q4K_DECODE=0", {"KCPP_Q4K_DECODE": "0"}, {},
         {"K3": n_mv, "K1": 0}, None),
        ("KCPP_PALLAS_MM=0", {"KCPP_PALLAS_MM": "0"}, {},
         {"K3": n_mv, "K1": 0}, None),
        ("KCPP_Q4K_2D=magic", {"KCPP_Q4K_2D": "magic"}, {}, {"K1": n_mv},
         ("K3.q4_k_magic", "K3")),
        ("KCPP_Q4K_RAW_X=0, KCPP_Q4K_I8=0",
         {"KCPP_Q4K_RAW_X": "0", "KCPP_Q4K_I8": "0"},
         {"KCPP_Q4K_I8": "0"}, {"K1": n_mv}, None),
        ("KCPP_FLASH_DECODE=0", {"KCPP_FLASH_DECODE": "0"}, {},
         {"K1": n_mv, "K5": L}, None))
    counts: dict = {}
    far = []
    for label, env, base, step, prefill in cases:
        base = dict({k: KV_DEFAULTS[k] for k in env}, **base)
        with _env(**env):
            eng = Engine(model, max_context=2048, device=DEV)
            _build.launches.clear()
            with _StepLaunches() as rec:
                r = eng.generate(prompt, gp)
            c = dict(_build.launches)
            n = _check_steps(rec, 1, step, label)
            if prefill:
                chunks = [d for (B, T), ds in rec.by_shape.items() if T > 1
                          for d in ds]
                _check(chunks and all(d.get(prefill[0], 0) > 0
                                      and not d.get(prefill[1])
                                      for d in chunks),
                       f"{label}: prefill chunks launched {chunks}")
            _check(len(r.tokens) == KV_DEPTH
                   and all(0 <= t < 32000 for t in r.tokens),
                   f"{label}: bad reply {r.tokens}")
            eng.reset_context()
            with torch.inference_mode():
                pre = eng.eval_tokens(prompt[:-1], 0).float()
                got = eng._forward(tok, pos, last_only=True)[0, -1].float()
                with _env(**base):
                    want = llama.forward(model.params, TINYLLAMA_1_1B, tok,
                                         pos, eng.cache, last_only=True)[0]
                    moved = llama.forward(
                        _embedding_nudged(model.params, prompt[-1]),
                        TINYLLAMA_1_1B, tok, pos, eng.cache,
                        last_only=True)[0]
                    ref = Engine(model, max_context=2048, device=DEV)
                    pre_want = ref.eval_tokens(prompt[:-1], 0).float()
                    del ref
            want, moved = want[0, -1].float(), moved[0, -1].float()
        del eng
        top = want.abs().max().item()
        spread = (moved - want).abs().max().item() / top
        tol = (AMPLIFIED_LOGIT_TOL if spread > 1e-2 else 2e-2) * top
        errs = [(got - want).abs().max().item(),
                (pre - pre_want).abs().max().item()]
        for what, err in zip(("decode-step", "prefill"), errs):
            if not (err <= tol and bool(torch.isfinite(got).all())):
                far.append(f"{label} {what} logits {err} from the "
                           f"defaults' > {tol}")
        print(f"kernel variables, synthetic TinyLlama-1.1B q4_k under "
              f"{label} ({card}): decode {r.timings.gen_tokens} tokens "
              f"{r.timings.gen_tps:.1f} tok/s; {n} decode steps of {step}"
              + (f", every prefill chunk {prefill[0]} and no {prefill[1]}"
                 if prefill else "")
              + f"; last-token logits vs {base}: decode step max abs err "
              f"{errs[0]:.4g}, prefill {errs[1]:.4g} (tol {tol:.4g}, max "
              f"|logit| {top:.4g}, the defaults moved by {spread:.4g} of it "
              f"with 1% of the token's embedding one bf16 step off); "
              f"launches {c}", flush=True)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    _check(not far, "; ".join(far))
    n7, n3 = _k7_or_k3(model, KV_SLOTS)
    _check(n7 > 0 and n3 > 0, f"KCPP_MATVEC_MAX_T: K7 {n7}, K3 {n3} a step")
    rng = np.random.default_rng(4)
    prompts = [[1] + rng.integers(3, 32000, size=m - 1).tolist()
               for m in (200, 300)]
    with _env(KCPP_Q4K_I8="0"), mock.patch.object(qm, "MATVEC_MAX_T",
                                                   KV_CAP):
        c = _serve_alone_and_together(
            model, KV_SLOTS, prompts, gp, {"K7": n7, "K3": n3},
            f"KCPP_MATVEC_MAX_T={KV_CAP}, KCPP_Q4K_I8=0, {KV_SLOTS} slots",
            card)
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    return counts


def phase_scan_decode(card: str, q4k_model) -> dict:
    """The scan decode path of the synthetic 1.1B at full depth and width:
    q4_k (every decode step 88 K17a and 22 K17c, the output head's K1,
    no K5 and no layer K1; prefill through K3), then q8_0 (88 K17b.q8_0,
    22 K17c, the head's K2.q8_0; prefill through K3.q8_0)."""
    L = TINYLLAMA_1_1B.n_layers
    counts = _scan_vs_unrolled(
        card, q4k_model.params, "q4_k", SCAN_DEPTH,
        {"K17a": 4 * L, "K17c": L, "K1": 1, "K5": 0, "K7": 0, "K3": 0},
        "K3")
    model = synthetic_model(TINYLLAMA_1_1B, "q8_0", seed=0, device=DEV)
    c8 = _scan_vs_unrolled(
        card, model.params, "q8_0", SCAN_Q8_DEPTH,
        {"K17b.q8_0": 4 * L, "K17c": L, "K2.q8_0": 1, "K5": 0, "K3.q8_0": 0},
        "K3.q8_0")
    del model
    torch.cuda.empty_cache()
    return {k: counts.get(k, 0) + c8.get(k, 0) for k in {*counts, *c8}}


# ---------------------------------------------------------------------------
# 5. the reference fixtures served over HTTP, and their logits against goldens
# ---------------------------------------------------------------------------

def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


class _Server:
    """The in-process HTTP server around an engine, on a free local port."""

    def __init__(self, engine, settings):
        from aiohttp import web

        from koboldcpp_tpu_torch.server.app import make_app

        self.loop = asyncio.new_event_loop()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.runner = web.AppRunner(make_app(engine, settings))
        self.loop.run_until_complete(self.runner.setup())
        self.loop.run_until_complete(
            web.TCPSite(self.runner, "127.0.0.1", self.port).start())
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def post(self, path: str, body: dict) -> dict:
        return _post(self.port, path, body)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def _multiuser_fixture(model, engine_kw: dict,
                       name: str = "tiny-q4_k_m") -> dict:
    """4 concurrent /api/v1/generate requests on a multiuser=4 server over
    BatchedEngine(**engine_kw): each reply must equal the one the request
    gets alone. Returns the launch counts of the concurrent requests."""
    from koboldcpp_tpu_torch.server.app import ServerSettings

    beng = batch_engine.BatchedEngine(model, max_context=512, n_slots=4,
                                      device=DEV, **engine_kw)
    reasons = []  # every request's stop reason: an error fails the phase
    finish = beng._finish
    beng._finish = lambda slot, why: (reasons.append(why), finish(slot, why))
    srv = _Server(beng, ServerSettings(model_name=name, multiuser=4))
    try:
        bodies = [{"prompt": p, "max_length": 16, "temperature": 0,
                   "rep_pen": 1.0}
                  for p in ("The gradient of a function, e.g. f(x), points",
                            "Once upon a time", "hello world, this is",
                            "A B C D")]
        _build.launches.clear()
        together: list = [None] * 4

        def one(i):
            together[i] = srv.post("/api/v1/generate",
                                   bodies[i])["results"][0]["text"]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        multi = dict(_build.launches)
        alone = []
        for bd in bodies:
            beng.reset_context()
            alone.append(srv.post("/api/v1/generate",
                                  bd)["results"][0]["text"])
    finally:
        srv.close()
        beng.shutdown()
    _check(not any(r.startswith("error") for r in reasons),
           f"multiuser requests failed: {reasons}")
    _check(together == alone and all(together),
           f"{name} multiuser replies {engine_kw} differ from the replies "
           f"alone: {together} {alone}")
    print(f"served {name}, multiuser=4 {engine_kw}: 4 concurrent "
          f"/api/v1/generate replies equal the replies alone; launches "
          f"{multi}", flush=True)
    return multi


def phase_served_fixture() -> dict:
    from koboldcpp_tpu_torch.server.app import ServerSettings

    model = load_model(os.path.join(FIX, "tiny-q4_k_m.gguf"), device=DEV)
    eng = Engine(model, max_context=512, device=DEV)
    srv = _Server(eng, ServerSettings(model_name="tiny"))
    try:
        body = {"prompt": "The gradient of a function, e.g. f(x), points",
                "max_length": 24, "temperature": 0, "rep_pen": 1.0}
        _build.launches.clear()
        a = srv.post("/api/v1/generate", body)["results"][0]["text"]
        b = srv.post("/api/v1/generate", body)["results"][0]["text"]
        c = srv.post("/v1/completions", {"prompt": "Once upon",
                                         "max_tokens": 8, "temperature": 0})
        counts = dict(_build.launches)
    finally:
        srv.close()
    _check(a == b and a != "", f"temperature-0 replies differ: {a!r} {b!r}")
    _check(c["object"] == "text_completion" and c["choices"][0]["text"] != "",
           f"bad /v1/completions reply {c}")
    _check(counts.get("K2", 0) > 0, "K2 did not run on the served fixture")
    print(f"served fixture: /api/v1/generate x2 identical ({a!r}); "
          f"/v1/completions {c['choices'][0]['text']!r}; launches {counts}",
          flush=True)

    # --quantkv 1 single-stream: the Q8 cache (K6)
    qeng = Engine(model, max_context=512, device=DEV, quantkv=1)
    srv = _Server(qeng, ServerSettings(model_name="tiny"))
    try:
        _build.launches.clear()
        qa, qb = (srv.post("/api/v1/generate", body)["results"][0]["text"]
                  for _ in range(2))
        q_counts = dict(_build.launches)
    finally:
        srv.close()
    _check(qa == qb and qa != "",
           f"--quantkv 1 temperature-0 replies differ: {qa!r} {qb!r}")
    _check(q_counts.get("K6", 0) > 0, "K6 did not run on the served fixture")
    print(f"served fixture, --quantkv 1: /api/v1/generate x2 identical "
          f"({qa!r}); launches {q_counts}", flush=True)
    for k, v in q_counts.items():
        counts[k] = counts.get(k, 0) + v

    # multiuser: 4 concurrent requests on the batched engine, each getting
    # the reply it gets alone; bf16 slot cache, then --quantkv 1 (the Q8
    # pool it forces)
    for kid, kw in (("K7", {}), ("K9", {"paged": True, "quantkv": 1})):
        multi = _multiuser_fixture(model, kw)
        _check(multi.get(kid, 0) > 0,
               f"{kid} did not run on the multiuser server {kw}: {multi}")
        for k, v in multi.items():
            counts[k] = counts.get(k, 0) + v

    return counts


# each served fixture (directory, format) -> the kernel bodies its packed
# kinds run single-stream, and the body of a multiuser=4 run (None: no
# multiuser run). tiny-q2_k holds q2_k and q3_k tensors (Q3_K attn_v,
# attn_output, ffn_down), tiny-q3_k_m q3_k only; Q6_K output in those.
# tiny-iq2_xs: IQ2_XS (G = 16: K12.iq2p for the 512-wide ffn_down, K13.iq2p
# at T=1 for the 256-wide rest); tiny-iq3_xxs: IQ3_XXS gate/up, IQ3_S
# attn_v / attn_output, IQ2_S attn_q / attn_k (all K13 at in_f 256);
# tiny-iq1_m: IQ1_M (G = 8: K12.iq1p from in_f 256), IQ2_XXS attn_output
# (K13.iq2p); Q5_K output in the three.
SERVED_KINDS = ((FIX, "q8_0", ("K2.q8_0",), "K3.q8_0"),
                (FIX, "q5_1", ("K1.q5_k",), "K7.q5_k"),
                (FIX, "q4_0", ("K1",), None),
                (FIX, "iq4_nl", ("K2.q8_0",), None),
                (FIX, "tq2_0", ("K2.q8_0",), None),
                (PORT_FIX, "q2_k", ("K12.q2_k", "K12.q3_k", "K13.q2_k"),
                 "K13.q2_k"),
                (PORT_FIX, "q3_k_m", ("K12.q3_k", "K13.q3_k"), None),
                (PORT_FIX, "iq2_xs", ("K12.iq2p", "K13.iq2p"), None),
                (PORT_FIX, "iq3_xxs", ("K13.iq2p", "K13.iq3px", "K13.iq3ps"),
                 None),
                (PORT_FIX, "iq1_m", ("K12.iq1p", "K13.iq1p", "K13.iq2p"),
                 "K13.iq1p"))


def phase_served_kinds() -> dict:
    """The fixtures whose weights pack as q8_0 (Q8_0, IQ4_NL, TQ2_0), q5_k
    (Q5_1), q4_k (Q4_0), q2_k (Q2_K), q3_k (Q3_K_M, and the Q2_K file's
    Q3_K tensors) and the IQ kinds (IQ2_XS, IQ3_XXS, IQ1_M), served over
    HTTP single-stream at temperature 0: two identical replies each,
    through the bodies of the fixture's kinds; tiny-q8_0, tiny-q5_1,
    tiny-q2_k and tiny-iq1_m also with multiuser=4 (each request getting
    the reply it gets alone; K3.q8_0 / K7.q5_k / K13.q2_k / K13.iq1p)."""
    from koboldcpp_tpu_torch.server.app import ServerSettings

    body = {"prompt": "The gradient of a function, e.g. f(x), points",
            "max_length": 24, "temperature": 0, "rep_pen": 1.0}
    counts: dict = {}
    for fix_dir, fmt, kids, multi_kid in SERVED_KINDS:
        model = load_model(os.path.join(fix_dir, f"tiny-{fmt}.gguf"),
                           device=DEV)
        srv = _Server(Engine(model, max_context=512, device=DEV),
                      ServerSettings(model_name=f"tiny-{fmt}"))
        try:
            _build.launches.clear()
            a, b = (srv.post("/api/v1/generate", body)["results"][0]["text"]
                    for _ in range(2))
            c = dict(_build.launches)
        finally:
            srv.close()
        _check(a == b and a != "",
               f"tiny-{fmt}: temperature-0 replies differ: {a!r} {b!r}")
        for kid in kids:
            _check(c.get(kid, 0) > 0, f"{kid} did not run on tiny-{fmt}: {c}")
        print(f"served tiny-{fmt}: /api/v1/generate x2 identical ({a!r}); "
              f"launches {c}", flush=True)
        if multi_kid:
            m = _multiuser_fixture(model, {}, f"tiny-{fmt}")
            _check(m.get(multi_kid, 0) > 0,
                   f"{multi_kid} did not run on the multiuser tiny-{fmt}: {m}")
            for k, v in m.items():
                c[k] = c.get(k, 0) + v
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts


# the served fixtures with no layer on the T=1 attention kernels: ALiBi
# (mpt, jais), and MLA's plain attention (deepseek2, minicpm3)
NO_DECODE_KERNEL = ("mpt", "jais", "deepseek2", "minicpm3")


def phase_served_archs() -> dict:
    """The gemma2, phi2 and mpt Q4_K_M fixtures (tests/fixtures/portgguf/
    archs.json), the mixtral, qwen2moe and grok ones (moe.json: 8
    experts, their stacks dense) and the deepseek2, minicpm3,
    chameleon (swin norm), openelm, bitnet, jais and plamo ones
    (late.json) served over HTTP single-stream at temperature 0: two
    identical replies each, q4_k through K1 / K3, the decode attention
    through K5 on gemma2's global layer, openelm's full-head layer, the
    other fixtures' layers and on none of NO_DECODE_KERNEL; then each
    fixture's logits on the card against the JAX package's committed
    logits, |err| <= 2e-2 + 2e-2 |want| (the tolerance of
    tests/test_torch_archs.py and test_torch_moe.py; the worst against the
    llama fixtures' 1e-2 + 1e-2 |want| is printed beside it)."""
    from koboldcpp_tpu_torch.server.app import ServerSettings

    mans = [json.load(open(os.path.join(PORT_FIX, m)))
            for m in ("archs.json", "moe.json", "late.json")]
    _check(all(m["tokens"] == mans[0]["tokens"] for m in mans),
           "manifests' tokens")
    tokens = mans[0]["tokens"]
    files = {arch: name for m in mans for arch, name in m["files"].items()}
    body = {"prompt": "The gradient of a function, e.g. f(x), points",
            "max_length": 24, "temperature": 0, "rep_pen": 1.0}
    counts: dict = {}
    for arch, name in files.items():
        path = os.path.join(PORT_FIX, name)
        model = load_model(path, device=DEV)
        srv = _Server(Engine(model, max_context=512, device=DEV),
                      ServerSettings(model_name=name))
        try:
            _build.launches.clear()
            a, b = (srv.post("/api/v1/generate", body)["results"][0]["text"]
                    for _ in range(2))
            c = dict(_build.launches)
        finally:
            srv.close()
        _check(a == b and a != "",
               f"{name}: temperature-0 replies differ: {a!r} {b!r}")
        _check(c.get("K1", 0) > 0 and c.get("K3", 0) > 0
               and (c.get("K5", 0) == 0) == (arch in NO_DECODE_KERNEL),
               f"{name}: launches {c}")
        logits = _fixture_logits(path, tokens)
        want = np.load(os.path.join(PORT_FIX, f"logits-jax-{arch}.npy"))
        diff = np.abs(logits - want)
        worst = float((diff / (2e-2 + 2e-2 * np.abs(want))).max())
        worst1 = float((diff / (1e-2 + 1e-2 * np.abs(want))).max())
        _check(worst <= 1.0, f"{name} logits off the JAX logits: |err| / "
               f"(2e-2 + 2e-2 |want|) {worst}")
        print(f"served {name}: /api/v1/generate x2 identical ({a!r}); "
              f"logits vs the JAX package's: max abs err "
              f"{float(diff.max()):.4g}, worst |err| / (2e-2 + 2e-2 |want|) "
              f"{worst:.3g} (/ (1e-2 + 1e-2 |want|) {worst1:.3g}); launches "
              f"{c}", flush=True)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts


def _fixture_logits(path: str, tokens: list[int]) -> np.ndarray:
    """A fixture's logits on the card, loaded packed in f32 (as
    tests/test_torch_forward.py does on the CPU), tokens at positions 0..
    (models/deepseek2.py's forward for deepseek2 / minicpm3)."""
    m32 = load_model(path, dtype=torch.float32, device=DEV)
    if m32.cfg.arch in ("deepseek2", "minicpm3"):
        fwd = ds2.forward
        cache = ds2.init_cache(m32.cfg, 1, 64, dtype=torch.float32,
                               device=DEV)
    else:
        fwd = llama.forward
        cache = init_cache(m32.cfg.n_layers, 1, 64, m32.cfg.n_kv_heads,
                           m32.cfg.head_dim, dtype=torch.float32, device=DEV)
    toks = torch.tensor([tokens], device=DEV)
    with torch.inference_mode():
        logits, _ = fwd(m32.params, m32.cfg, toks,
                        torch.arange(toks.shape[1], device=DEV)[None], cache)
    return logits[0].float().cpu().numpy()


def check_fixture_goldens() -> None:
    """Each reference fixture's logits on the card against the reference
    runtime's goldens at tests/test_ref_gguf_fixtures.py's tolerances; then
    the Q2_K, Q3_K_M, IQ2_XS, IQ3_XXS and IQ1_M fixtures' against the JAX
    package's committed logits
    (tests/fixtures/portgguf, no reference-runtime goldens exist for them)
    at tests/test_torch_lowbit.py's 1e-2 (|err| <= 1e-2 + 1e-2 |want|)."""
    manifest = json.load(open(os.path.join(FIX, "manifest.json")))
    for fmt, name in manifest["files"].items():
        logits = _fixture_logits(os.path.join(FIX, name), manifest["tokens"])
        golden = np.load(os.path.join(FIX, f"logits-{fmt}.npy"))
        err = float(np.abs(logits - golden).max())
        tol = 2e-3 if fmt == "f16" else 4e-2
        _check(err <= tol, f"tiny-{fmt} logits off the goldens by {err}")
        print(f"tiny-{fmt} logits vs reference goldens: max abs err "
              f"{err:.4g} (tol {tol:g})", flush=True)
    manifest = json.load(open(os.path.join(PORT_FIX, "manifest.json")))
    for fmt, name in manifest["files"].items():
        logits = _fixture_logits(os.path.join(PORT_FIX, name),
                                 manifest["tokens"])
        want = np.load(os.path.join(PORT_FIX, f"logits-jax-{fmt}.npy"))
        diff = np.abs(logits - want)
        worst = float((diff / (1e-2 + 1e-2 * np.abs(want))).max())
        _check(worst <= 1.0,
               f"tiny-{fmt} logits off the JAX logits: |err| / (1e-2 + "
               f"1e-2 |want|) {worst}")
        print(f"tiny-{fmt} logits vs the JAX package's: max abs err "
              f"{float(diff.max()):.4g}, worst |err| / (1e-2 + 1e-2 |want|) "
              f"{worst:.3g}", flush=True)


# fixture -> the variables it is served under, and the bodies that must
# run (tiny-q3_k_m's Q6_K output runs K12.q6_k_i8f too)
SERVED_OPT_IN = (
    ("refgguf/tiny-q6_k.gguf", {"KCPP_KQ_LAYOUT": "expanded"},
     ("K12.q6_k_i8f",)),
    ("portgguf/tiny-q3_k_m.gguf", {"KCPP_KQ_LAYOUT": "expanded"},
     ("K12.q3_k_n4", "K12.q6_k_i8f")),
    ("refgguf/tiny-q4_k_m.gguf", {"KCPP_Q4K_LAYOUT": "i8"},
     ("K13.q4_k_i8",)),
    ("refgguf/tiny-q8_0.gguf", {"KCPP_MM_I8": "0"}, ("K2.q8_0_bf16",)))


def phase_served_opt_in() -> dict:
    """The fixtures of SERVED_OPT_IN served over HTTP single-stream under
    their variables at temperature 0: two identical replies each, through
    the opt-in bodies."""
    from koboldcpp_tpu_torch.server.app import ServerSettings

    body = {"prompt": "The gradient of a function, e.g. f(x), points",
            "max_length": 24, "temperature": 0, "rep_pen": 1.0}
    counts: dict = {}
    for fixture, env, kids in SERVED_OPT_IN:
        with _env(**env):
            model = load_model(os.path.join(ROOT, "tests", "fixtures",
                                            fixture), device=DEV)
            srv = _Server(Engine(model, max_context=512, device=DEV),
                          ServerSettings(model_name=fixture))
            try:
                _build.launches.clear()
                a, b = (srv.post("/api/v1/generate",
                                 body)["results"][0]["text"]
                        for _ in range(2))
                c = dict(_build.launches)
            finally:
                srv.close()
        _check(a == b and a != "",
               f"{fixture} {env}: temperature-0 replies differ: {a!r} {b!r}")
        for kid in kids:
            _check(c.get(kid, 0) > 0, f"{kid} did not run on {fixture}: {c}")
        print(f"served {fixture} under {env}: /api/v1/generate x2 identical "
              f"({a!r}); launches {c}", flush=True)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts


def check_opt_in_logits() -> None:
    """The runs of tests/fixtures/portgguf/optin.json on the card: each
    fixture loaded packed in f32 under its variable, the tokens as a
    prefill of 11 and one decode step, against the JAX package's logits
    under the same variable (tests/make_torch_optin_logits.py) at
    tests/test_torch_opt_in_layouts.py's tolerances: |err| <= 1e-2 +
    1e-2 |want| for the prefill rows, 2e-2 + 2e-2 |want| for the decode
    row (its bf16-activation output projection, see that test). The f32
    cache is kept throughout, as in the JAX run and the CPU test: the
    decode step attends through K5's f32 kind, its projections through the
    opt-in bodies under test."""
    manifest = json.load(open(os.path.join(PORT_FIX, "optin.json")))
    for run, spec in manifest["runs"].items():
        with _env(**spec["env"]):
            m32 = load_model(os.path.join(ROOT, "tests", "fixtures",
                                          spec["fixture"]),
                             dtype=torch.float32, device=DEV)
            cache = init_cache(m32.cfg.n_layers, 1, 64, m32.cfg.n_kv_heads,
                               m32.cfg.head_dim, dtype=torch.float32,
                               device=DEV)
            toks = torch.tensor([manifest["tokens"]], device=DEV)
            n = toks.shape[1] - 1
            _build.launches.clear()
            with torch.inference_mode():
                pre, cache = llama.forward(
                    m32.params, m32.cfg, toks[:, :n],
                    torch.arange(n, device=DEV)[None], cache)
                last, _ = llama.forward(
                    m32.params, m32.cfg, toks[:, n:],
                    torch.tensor([[n]], device=DEV), cache)
            c = dict(_build.launches)
        _check(c.get("K5", 0) == m32.cfg.n_layers,
               f"{run}: the decode step over the f32 cache did not run K5 "
               f"once per layer: {c}")
        logits = torch.cat([pre[0], last[0]]).float().cpu().numpy()
        want = np.load(os.path.join(PORT_FIX, spec["logits"]))
        diff = np.abs(logits - want)
        worst = max(float((diff[:n] / (1e-2 + 1e-2 * np.abs(want[:n])))
                          .max()),
                    float((diff[n:] / (2e-2 + 2e-2 * np.abs(want[n:])))
                          .max()))
        _check(worst <= 1.0, f"{run} logits off the JAX logits: worst "
               f"|err| / tol {worst}")
        print(f"{run} logits vs the JAX package's under {spec['env']}: max "
              f"abs err {float(diff.max()):.4g}, worst |err| / tol "
              f"{worst:.3g}; launches {c}", flush=True)


# ---------------------------------------------------------------------------
# 8. the served features of the single-stream path (stochastic chunks,
#    state, smart context, LoRA, legacy containers, routes, launcher)
# ---------------------------------------------------------------------------

# (the host loop of the pairs pays its time per token)
FEATURE_DEPTH = 32  # stochastic tokens of the repeatability check
PAIR_DEPTH = 16      # tokens of each timed run in the interleaved pairs
# the smart-context script at --contextsize 2048: a 1700-token prompt, a
# diverging 1700-token prompt (the halving: 849 tokens kept), then that
# prompt with its reply and 300 new tokens (the kept half reused); the
# prompt tokens the JAX rule evaluates on each turn, as
# tests/test_torch_engine_features.py::test_smart_context_chip_script
# holds them
SMART_TURNS = (1700, 849, 300)


def _get(port: int, path: str) -> tuple[int, str, bytes]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.status, r.headers.get_content_type(), r.read()


def _rand_q4_0(rng, rows: int, cols: int) -> np.ndarray:
    """Random Q4_0 blocks (f16 d, 16 bytes of nibbles), (rows, cols/32*18)
    bytes: weights d*(q-8) of std ~0.02."""
    nb = cols // 32
    blocks = rng.integers(0, 256, size=(rows, nb, 18), dtype=np.uint8)
    d = np.abs(rng.normal(0.004, 0.001, size=(rows, nb))).astype(np.float16)
    blocks[:, :, :2] = d[..., None].view(np.uint8)
    return blocks.reshape(rows, nb * 18)


def _write_ggjt3(path: str, vocab: int, C: int, n_head: int, n_layer: int,
                 n_mult: int, tensors: dict) -> None:
    """A GGJT v3 llama container (llama_v3.cpp:521-560): magic and
    version, 7 u32 hparams, the vocabulary with scores, then each tensor's
    header, its name, padding to 32 bytes and its data. tensors:
    {legacy name: (shape, ggml type, raw bytes)}."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack("<II", 0x67676A74, 3))
        f.write(struct.pack("<7I", vocab, C, n_mult, n_head, n_layer,
                            C // n_head, 2))
        for i in range(vocab):
            tok = f"tok{i}".encode()
            f.write(struct.pack("<I", len(tok)) + tok
                    + struct.pack("<f", -float(i)))
        for name, (shape, ttype, raw) in tensors.items():
            nm = name.encode()
            f.write(struct.pack("<3I", len(shape), len(nm), ttype))
            f.write(struct.pack(f"<{len(shape)}I", *reversed(shape)))
            f.write(nm)
            f.write(b"\0" * ((-f.tell()) % 32))
            f.write(np.ascontiguousarray(raw).tobytes())


def _legacy_files(d: str) -> tuple[str, str, dict]:
    """The 1.1B's widths at 2 layers (32 kv heads: a GGJT v3 llama file
    has no kv-head count), random Q4_0 weights: written as GGJT v3 and, the
    same blocks with the reader's metadata, as GGUF. Returns (ggjt path,
    gguf path, {gguf name: raw})."""
    from koboldcpp_tpu_torch.gguf.constants import GGMLType
    from koboldcpp_tpu_torch.gguf.legacy import LegacyLlamaReader
    from koboldcpp_tpu_torch.gguf.writer import GGUFWriter

    cfg = TINYLLAMA_1_1B
    C, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    rng = np.random.default_rng(18)
    legacy = {"token_embd.weight": "tok_embeddings.weight",
              "output_norm.weight": "norm.weight",
              "output.weight": "output.weight"}
    per_layer = {"attn_q": ("attention.wq", C), "attn_k": ("attention.wk", C),
                 "attn_v": ("attention.wv", C),
                 "attn_output": ("attention.wo", C),
                 "ffn_gate": ("feed_forward.w1", F),
                 "ffn_down": ("feed_forward.w2", C),
                 "ffn_up": ("feed_forward.w3", F)}
    tensors, raws = {}, {}
    for g in ("token_embd.weight", "output.weight"):
        raws[g] = _rand_q4_0(rng, V, C)
        tensors[legacy[g]] = ((V, C), 2, raws[g])
    norm = (1.0 + rng.normal(0, 0.01, C)).astype(np.float32)
    tensors["norm.weight"] = ((C,), 0, norm)
    raws["output_norm.weight"] = norm
    for i in range(2):
        for g, (lname, rows) in per_layer.items():
            cols = F if g == "ffn_down" else C
            raw = _rand_q4_0(rng, rows, cols)
            raws[f"blk.{i}.{g}.weight"] = raw
            tensors[f"layers.{i}.{lname}.weight"] = ((rows, cols), 2, raw)
        for g, lname in (("attn_norm", "attention_norm"),
                         ("ffn_norm", "ffn_norm")):
            w = (1.0 + rng.normal(0, 0.01, C)).astype(np.float32)
            raws[f"blk.{i}.{g}.weight"] = w
            tensors[f"layers.{i}.{lname}.weight"] = ((C,), 0, w)
    ggjt = os.path.join(d, "legacy-q4_0.bin")
    _write_ggjt3(ggjt, V, C, cfg.n_heads, 2, 256, tensors)
    with LegacyLlamaReader(ggjt) as r:
        md = dict(r.metadata)
    gguf = os.path.join(d, "same-q4_0.gguf")
    w = GGUFWriter(gguf)
    for k, v in md.items():
        w.add(k, v)
    for name, raw in raws.items():
        if raw.dtype == np.uint8:
            w.add_tensor_raw(name, (raw.shape[0], raw.shape[1] // 18 * 32),
                             GGMLType.Q4_0, raw)
        else:
            w.add_tensor(name, raw)
    w.write()
    return ggjt, gguf, raws


def _lora_file(path: str, rng, C: int) -> dict:
    """A rank-8 LoRA on attn_q / attn_v of both layers, written with the
    port's GGUF writer; returns {tensor name: f32 delta}."""
    from koboldcpp_tpu_torch.gguf.writer import GGUFWriter

    alpha, rank = 16.0, 8
    w = GGUFWriter(path, architecture="llama")
    w.add("general.type", "adapter")
    w.add("adapter.type", "lora")
    w.add("adapter.lora.alpha", np.float32(alpha))
    deltas = {}
    for i in range(2):
        for g in ("attn_q", "attn_v"):
            a = (rng.standard_normal((rank, C)) * 0.02).astype(np.float32)
            b = (rng.standard_normal((C, rank)) * 0.02).astype(np.float32)
            name = f"blk.{i}.{g}.weight"
            w.add_tensor(name + ".lora_a", a)
            w.add_tensor(name + ".lora_b", b)
            deltas[name] = (alpha / rank) * (b @ a)
    w.write()
    return deltas


def _first_logits(model, tokens: list[int]) -> torch.Tensor:
    eng = Engine(model, max_context=256, device=DEV)
    with torch.inference_mode():
        out = eng._eval_chunk(tokens, 0).float()
    torch.cuda.synchronize()
    return out


def phase_served_features(card: str) -> dict:
    """The single-stream path's served features on the synthetic 1.1B
    (full widths and depth; q4_k layers, a q6_k head: K1, K2, K5 every
    token): stochastic chunks (repeatable under a seed, top-k 1 = the
    greedy chunks, the chunk's candidate distribution = the plain one, K1
    / K2 / K5 inside the chunks; greedy chunk, stochastic chunk and the
    host-sampled loop timed in interleaved pairs), save / load state, smart
    context; then at the 1.1B's widths and 2 layers a LoRA merged at load
    against a hand-merged model and a GGJT v3 Q4_0 file against the same
    blocks as GGUF; then the Lite page, /api/tags, `--benchmark`, and last
    (a profiler session slows later decodes) the profiler routes around
    one generate. Returns the launches of the stochastic run."""
    import contextlib
    import io
    import tempfile

    from koboldcpp_tpu_torch import cli
    from koboldcpp_tpu_torch.engine import device_sampler as tds
    from koboldcpp_tpu_torch.engine import engine as engine_mod
    from koboldcpp_tpu_torch.gguf import quants as gq
    from koboldcpp_tpu_torch.gguf.constants import GGMLType
    from koboldcpp_tpu_torch.ops import linear
    from koboldcpp_tpu_torch.server.app import ServerSettings

    V, C = TINYLLAMA_1_1B.vocab_size, TINYLLAMA_1_1B.hidden_size
    model = synthetic_model(TINYLLAMA_1_1B, "q4_k", seed=0, device=DEV)
    rng = np.random.default_rng(3)
    model.params["output"] = rand_q6k(rng, V, C, DEV)  # Q4_K_M's head
    eng = Engine(model, max_context=2048, device=DEV)
    prompt = [1] + rng.integers(3, V, size=299).tolist()
    greedy_sp = SamplerParams(temperature=0.0, rep_pen=1.0)
    stoch_sp = SamplerParams(temperature=0.8, top_p=0.9, min_p=0.05,
                             rep_pen=1.1, seed=1234)
    gp_stoch = GenParams(max_length=FEATURE_DEPTH, bypass_eos=True,
                         sampler=stoch_sp)
    _check(eng._fast_stoch_ok(gp_stoch, None), "the preset left the chunks")
    for sp in (greedy_sp, stoch_sp):  # warm-up
        eng.generate(prompt[:40], GenParams(max_length=40, bypass_eos=True,
                                            sampler=sp))
    eng.reset_context()

    # -- stochastic chunks: launches inside them, repeatability ------------
    inside: dict = {}
    real_chunk = eng._get_stoch_chunk

    def counted(order):
        fn = real_chunk(order)

        def run(*a):
            before = dict(_build.launches)
            out = fn(*a)
            for k, n in _build.launches.items():
                inside[k] = inside.get(k, 0) + n - before.get(k, 0)
            return out
        return run

    eng._get_stoch_chunk = counted
    _build.launches.clear()
    r1 = eng.generate(prompt, gp_stoch)
    t1 = eng.last_timings
    counts = dict(_build.launches)
    r2 = eng.generate(prompt, gp_stoch)
    del eng._get_stoch_chunk
    _check(len(r1.tokens) == FEATURE_DEPTH and r2.tokens == r1.tokens,
           "seeded stochastic decode is not repeatable")
    _check(eng.last_timings.prompt_tokens == 1, "stochastic: no fast-forward")
    K = engine_mod.FAST_DECODE_K
    n_chunked = 2 * -(-FEATURE_DEPTH // K) * K
    for k in ("K1", "K2", "K5"):
        _check(inside.get(k, 0) > 0, f"{k} did not run inside the chunks")
    L = TINYLLAMA_1_1B.n_layers  # 4 q4_k projections and K5 a layer
    _check(inside["K1"] == 4 * L * n_chunked and inside["K2"] == n_chunked
           and inside["K5"] == L * n_chunked,
           f"chunk launches {inside} for {n_chunked} tokens")
    print(f"stochastic chunks (synthetic TinyLlama-1.1B q4_k + q6_k head, "
          f"{card}): {FEATURE_DEPTH} tokens at temperature 0.8, top-p 0.9, "
          f"min-p 0.05, rep-pen 1.1, seed 1234, twice: the same tokens; "
          f"decode {t1.gen_tps:.1f} tok/s; inside the chunks {inside} "
          f"({n_chunked} tokens computed); launches {counts}", flush=True)

    # top-k 1: the greedy chunks' tokens
    gp_k1 = GenParams(max_length=FEATURE_DEPTH, bypass_eos=True,
                      sampler=SamplerParams(temperature=0.8, top_k=1,
                                            rep_pen=1.0, seed=5))
    eng.reset_context()
    greedy = eng.generate(prompt, GenParams(
        max_length=FEATURE_DEPTH, bypass_eos=True, sampler=greedy_sp)).tokens
    eng.reset_context()
    k1 = eng.generate(prompt, gp_k1).tokens
    _same_or_near_tie(eng, prompt, k1, greedy, "top-k 1 stochastic chunks")

    # the chain as the chunk runs it on the card against the plain one
    eng.reset_context()
    with torch.inference_mode():
        logits = eng.eval_tokens(prompt, 0).float()
    dyn = tds.make_dyn(stoch_sp, 2048, DEV)
    rec = torch.zeros(2048, dtype=torch.int64)
    rec[-len(prompt):] = torch.tensor(prompt)
    bias = torch.zeros(V)
    p_dev = tds.candidate_distribution(
        logits, bias.to(DEV), rec.to(DEV),
        torch.tensor([len(prompt)], device=DEV), dyn, stoch_sp.sampler_order)
    p_plain = tds.candidate_distribution(
        logits.cpu(), bias, rec, len(prompt), tds.make_dyn(stoch_sp, 2048),
        stoch_sp.sampler_order)
    err = float((p_dev.cpu() - p_plain).abs().max())
    _check(err <= 1e-5 and bool(((p_dev.cpu() > 0) == (p_plain > 0)).all()),
           f"device candidate distribution off by {err}")
    print(f"candidate distribution at one step, on the card vs the plain "
          f"chain on the CPU: max abs err {err:.3g} (tol 1e-5), "
          f"{int((p_plain > 0).sum())} candidates", flush=True)

    # tok/s in interleaved pairs: greedy chunk, stochastic chunk, host loop
    paths = {"greedy chunk": ({}, greedy_sp),
             "stochastic chunk": ({}, stoch_sp),
             "host loop (KCPP_FAST_DECODE=0)": ({"KCPP_FAST_DECODE": "0"},
                                                stoch_sp)}
    tps: dict = {k: [] for k in paths}
    for _ in range(2):
        for name, (env, sp) in paths.items():
            with _env(**env):
                eng.generate(prompt, GenParams(max_length=PAIR_DEPTH,
                                               bypass_eos=True, sampler=sp))
            tps[name].append(eng.last_timings.gen_tps)
    print(f"decode tok/s, {PAIR_DEPTH} tokens, in turns ({card}): "
          + "; ".join(f"{k} {[round(v, 1) for v in vs]}"
                      for k, vs in tps.items()), flush=True)

    # -- save / load state --------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="kcpp_smoke_")
    firsts: list = []
    real_eval = eng._eval_chunk

    def rec_eval(tokens, start):
        out = real_eval(tokens, start)
        firsts.append(out.clone())
        return out

    eng.reset_context()
    eng.generate(prompt, GenParams(max_length=1, bypass_eos=True,
                                   sampler=greedy_sp))
    ctx = list(eng.context_tokens)
    state = os.path.join(tmp, "state.npz")
    eng.save_state(state)
    g32 = GenParams(max_length=32, bypass_eos=True, sampler=greedy_sp)
    eng._eval_chunk = rec_eval
    before = eng.generate(ctx, g32).tokens
    first_before = firsts[0]
    eng.reset_context()
    eng.generate([1] + rng.integers(3, V, size=199).tolist(),
                 GenParams(max_length=16, sampler=greedy_sp))
    eng.load_state(state)
    _check(eng.context_tokens == ctx, "load_state: other context tokens")
    firsts.clear()
    after = eng.generate(ctx, g32).tokens
    del eng._eval_chunk
    _check(after == before and torch.equal(firsts[0], first_before),
           "state: the restored cache gives other tokens or logits")
    print(f"state: save after the {len(ctx)}-token context, an unrelated "
          f"prompt, load: the next 32 greedy tokens and the first logits "
          f"bit-equal ({os.path.getsize(state) / 2**20:.1f} MiB npz)",
          flush=True)

    # -- smart context --------------------------------------------------------
    sc = Engine(model, max_context=2048, device=DEV, use_smartcontext=True)
    a = [1] + rng.integers(3, V, size=1699).tolist()
    b = a[:2] + rng.integers(3, V, size=1698).tolist()
    g4 = GenParams(max_length=4, bypass_eos=True, sampler=greedy_sp)
    seen = []
    sc.generate(a, g4)
    seen.append(sc.last_timings.prompt_tokens)
    rb = sc.generate(b, g4)
    seen.append(sc.last_timings.prompt_tokens)
    sc.generate(b + rb.tokens + rng.integers(3, V, size=300).tolist(), g4)
    seen.append(sc.last_timings.prompt_tokens)
    _check(tuple(seen) == SMART_TURNS and sc.smartcontext,
           f"smart context evaluated {seen}, the JAX rule {SMART_TURNS}")
    print(f"smart context (--contextsize 2048): prompt tokens per turn "
          f"{seen}, as the JAX rule predicts", flush=True)
    del sc
    torch.cuda.empty_cache()

    # -- legacy GGJT v3 and LoRA, the 1.1B's widths at 2 layers -------------
    t0 = time.perf_counter()
    ggjt, gguf, raws = _legacy_files(tmp)
    toks = [1] + rng.integers(3, V, size=15).tolist()
    base = load_model(gguf, device=DEV)
    want = _first_logits(base, toks)
    got = _first_logits(load_model(ggjt, device=DEV), toks)
    _check(torch.equal(got, want), "GGJT v3 logits differ from the GGUF's")
    print(f"legacy GGJT v3 Q4_0 (1.1B widths, 2 layers, 32 kv heads; "
          f"files written in {time.perf_counter() - t0:.1f} s): logits "
          f"bit-equal to the same blocks as GGUF", flush=True)
    deltas = _lora_file(os.path.join(tmp, "lora.gguf"), rng, C)
    merged = load_model(gguf, device=DEV,
                        loras=[(os.path.join(tmp, "lora.gguf"), 1.0)])
    for i, layer in enumerate(base.params["layers"]):  # the hand merge
        w = np.concatenate([
            gq.dequantize(raws[f"blk.{i}.{g}.weight"], GGMLType.Q4_0)
            .reshape(-1, C) + deltas.get(f"blk.{i}.{g}.weight", 0.0)
            for g in ("attn_q", "attn_k", "attn_v")], axis=0)
        layer["wqkv"] = linear.dense(w, device=DEV)
    want = _first_logits(base, toks)
    _check(all(lay["wqkv"].kind == "dense" and lay["wo"].kind == "q4_k"
               for lay in merged.params["layers"]),
           "LoRA: wqkv not dense, or the other weights not packed")
    _build.launches.clear()
    got = _first_logits(merged, toks)
    Engine(merged, max_context=256, device=DEV).generate(
        toks, GenParams(max_length=4, bypass_eos=True, sampler=greedy_sp))
    lora_counts = dict(_build.launches)
    err = float((got - want).abs().max())
    tol = 2 ** -6 * float(want.abs().max())
    _check(err <= tol, f"LoRA logits off the hand-merged model's by {err}")
    _check(lora_counts.get("K1", 0) > 0, f"LoRA: K1 did not run {lora_counts}")
    print(f"LoRA rank 8 on attn_q / attn_v of both layers, merged at load: "
          f"logits within {err:.4g} of the hand-merged model's (tol "
          f"{tol:.4g}); launches {lora_counts}", flush=True)
    del base, merged
    torch.cuda.empty_cache()

    # -- the launcher's --benchmark on the card ------------------------------
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _check(cli.main([gguf, "--benchmark"]) == 0, "--benchmark failed")
    line = [ln for ln in out.getvalue().splitlines()
            if "ProcessingSpeed" in ln]
    _check(bool(line) and "on cuda" in out.getvalue(),
           f"--benchmark printed {out.getvalue()[-500:]}")
    print(f"cli --benchmark (the 2-layer Q4_0 GGUF, {card}): {line[0]}",
          flush=True)

    # -- routes: the Lite page, /api/tags, then the profiler around one
    #    generate (last: a profiler session slows later decodes) ----------
    srv = _Server(eng, ServerSettings(model_name="synthetic-1.1b"))
    try:
        st, ctype, page = _get(srv.port, "/")
        _check(st == 200 and ctype == "text/html"
               and b"KoboldAI" in page and len(page) > 20000,
               f"/ did not serve the Lite page ({st}, {ctype})")
        st, ctype, tags = _get(srv.port, "/api/tags")
        _check(st == 200 and json.loads(tags)["models"][0]["name"]
               == "synthetic-1.1b", f"/api/tags: {st} {tags[:200]}")
        body = {"prompt": "tok5 tok9 tok77", "max_length": 16,
                "temperature": 0, "rep_pen": 1.0}
        srv.post("/api/v1/generate", body)
        trace_dir = os.path.join(tmp, "trace")
        started = srv.post("/api/extra/profiler/start", {"dir": trace_dir})
        srv.post("/api/v1/generate", body)
        stopped = srv.post("/api/extra/profiler/stop", {})
    finally:
        srv.close()
    _check(started.get("success") and stopped.get("files") == ["trace.json"],
           f"profiler routes: {started} {stopped}")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    ours = sorted(n[:40] for n in names if any(
        s in n for s in ("q4k_i8_kernel", "flash_decode_kernel",
                         "kq_wgmma", "kq_swap", "flash_prefill_kernel")))
    _check(bool(ours), f"the trace names none of the port's kernels: "
           f"{sorted(names)[:10]}")
    print(f"served routes: / (the Lite page, {len(page)} bytes), /api/tags; "
          f"profiler start / stop around one generate: trace.json with "
          f"{len(names)} kernel names, of the port's {ours[:4]}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the vision and speech inputs
# ---------------------------------------------------------------------------

# LLaVA-1.5-7B at full depth: the CLIP ViT-L/14-336 tower (23 of its 24
# layers run: select_layer -2) with the mlp2x_gelu projector, and the
# LLaMA-2-7B-width LM (synthetic "q4_k_m" weights drawn on the card)
LLAVA_PROMPT = 20   # text tokens after BOS
LLAVA_DEPTH = 32    # greedy tokens: one device chunk
LLAVA_PLAIN_DEPTH = 8  # of them under the plain matmuls (host loop)
LLAVA_BATCH_DEPTH = 16  # greedy tokens of each batched request
# the image embeddings and whisper's outputs on the card against the same
# f32 module on the CPU: |err| <= EMBED_TOL (1 + |want|)
EMBED_TOL = 1e-3


def _png_b64(rng, w: int, h: int) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _cpu_copy(params: dict) -> dict:
    return {k: v.detach().cpu() for k, v in params.items()}


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Hold got (card) to want (CPU f32) at EMBED_TOL; returns the worst
    |err| / (EMBED_TOL (1 + |want|))."""
    g, w = got.float().cpu(), want.float()
    _check(g.shape == w.shape and bool(torch.isfinite(g).all()),
           f"{what}: shape {tuple(g.shape)} vs {tuple(w.shape)} or not finite")
    worst = float(((g - w).abs() / (EMBED_TOL * (1 + w.abs()))).max())
    _check(worst <= 1.0, f"{what}: |err| / ({EMBED_TOL} (1 + |want|)) "
           f"{worst}")
    print(f"{what}: card against the CPU in f32, max abs err "
          f"{float((g - w).abs().max()):.3g}, worst |err| / ({EMBED_TOL} "
          f"(1 + |want|)) {worst:.3g}", flush=True)
    return worst


def _llava_same(eng: Engine, prompt, images, got, want, what) -> None:
    """got == want (or the shorter a prefix of the longer), else equal up to
    a step where the single-stream logits of the two picks, after the
    spliced image, lie within NEAR_TIE (printed)."""
    n = min(len(got), len(want))
    if got[:n] == want[:n]:
        return
    i = next(j for j in range(n) if got[j] != want[j])
    if not images:
        return _same_or_near_tie(eng, prompt, got, want, what)
    eng.reset_context()
    with torch.inference_mode():
        ctx, emb = splice_images(eng.clip, eng.tokenizer.vocab.add_bos,
                                 list(prompt), images)
        lg = eng.eval_tokens(ctx + got[:i], 0, emb).float()
    a, b = lg[got[i]].item(), lg[want[i]].item()
    _check(abs(a - b) <= NEAR_TIE,
           f"{what}: tokens part at step {i} ({got[i]} vs {want[i]}), "
           f"single-stream logits {a} vs {b}")
    print(f"near-tie: {what}, step {i}: tokens {got[i]} / {want[i]}, "
          f"single-stream logits {a:.6f} / {b:.6f}", flush=True)


def phase_llava(card: str) -> dict:
    """LLaVA-1.5-7B's widths at full depth: `synthetic_clip` (CLIP
    ViT-L/14-336, f32) and `synthetic_q4_k_m_on_device(LLAMA2_7B)`. A
    seeded 640 x 480 PNG's 576 patch embeddings on the card against the same
    module on the CPU (f32); one request through Engine.generate (BOS, the
    image's 576 rows, LLAVA_PROMPT text tokens: two prefill chunks of 512
    and 85 rows, each through `forward` with the rows spliced in, every
    q4_k / q6_k projection through K3; then LLAVA_DEPTH greedy tokens, one
    device chunk: K1 / K2 / K5 a step), its first LLAVA_PLAIN_DEPTH
    tokens against the same request under the plain matmuls (near-ties
    apart); then two image requests and a text request together through
    BatchedEngine (4 slots) on the slot cache and on the paged pool (P =
    64), each request's tokens equal to its single-stream run. Prints the
    image encode ms, prefill ms, decode tok/s and the peak memory. Returns
    the launches of the single and batched runs."""
    t0 = time.perf_counter()
    clip = synthetic_clip(llm_hidden=LLAMA2_7B.hidden_size, seed=0,
                          device=DEV)
    model = synthetic_q4_k_m_on_device(LLAMA2_7B, seed=0, device=DEV)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(22)
    images = [_png_b64(rng, 640, 480) for _ in range(3)]
    prompts = [[1] + rng.integers(3, LLAMA2_7B.vocab_size,
                                  size=LLAVA_PROMPT).tolist()
               for _ in range(3)]

    # the embeddings: card against the CPU in f32
    from koboldcpp_tpu_torch.models.clip import (ClipModel,
                                                 decode_image_base64)

    px = decode_image_base64(images[0], clip.cfg.image_size)
    emb = clip.image_embed(px)
    cpu = ClipModel(clip.cfg, _cpu_copy(clip.params), torch.device("cpu"))
    _close(emb, cpu.image_embed(px), "CLIP ViT-L/14-336 + projector "
           "embeddings (576 x 4096)")
    del cpu
    enc_ms = _event_ms(lambda: clip.image_embed(px))

    gp = GenParams(max_length=LLAVA_DEPTH, bypass_eos=True,
                   images=images[:1],
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    eng = Engine(model, max_context=2048, device=DEV, clip_model=clip)
    eng.generate(prompts[0][:4], dataclasses.replace(gp, max_length=4))
    _build.launches.clear()
    r1 = eng.generate(prompts[0], gp)
    counts = dict(_build.launches)
    t1 = r1.timings
    n_img = clip.cfg.n_patches
    _check(len(r1.tokens) == LLAVA_DEPTH
           and eng.context_tokens.count(eng.IMG_SENTINEL) == n_img
           and t1.prompt_tokens == 1 + n_img + LLAVA_PROMPT,
           f"LLaVA: tokens {r1.tokens}, {t1.prompt_tokens} prompt rows")
    _check(all(counts.get(k, 0) > 0 for k in ("K1", "K2", "K3", "K5"))
           and counts.get("K4", 0) == 0,
           f"LLaVA: the request missed a kernel (or took K4): {counts}")
    eng.reset_context()
    with _plain_matmuls(), _env(KCPP_FAST_DECODE="0"):
        r2 = eng.generate(prompts[0], dataclasses.replace(
            gp, max_length=LLAVA_PLAIN_DEPTH))
    _llava_same(eng, prompts[0], images[:1], r1.tokens, r2.tokens,
                "LLaVA single-stream, K1 / K2 / K3 against their plain "
                "versions")

    # four slots: two image requests and a text request, alone and together
    reqs = [(prompts[0], images[:1]), (prompts[1], images[1:2]),
            (prompts[2], [])]
    bgp = [dataclasses.replace(gp, max_length=LLAVA_BATCH_DEPTH,
                               images=list(imgs)) for _, imgs in reqs]
    alone = []
    for (p, _), g in zip(reqs, bgp):
        eng.reset_context()
        alone.append(eng.generate(p, g).tokens)
    del eng
    torch.cuda.empty_cache()
    lines = []
    for paged in (False, True):
        beng = batch_engine.BatchedEngine(model, max_context=2048, n_slots=4,
                                          paged=paged, page_size=64,
                                          device=DEV, clip_model=clip)
        try:
            _build.launches.clear()
            res, secs = _serve_together(beng, [p for p, _ in reqs], bgp)
            bc = dict(_build.launches)
        finally:
            beng.shutdown()
        single = Engine(model, max_context=2048, device=DEV, clip_model=clip)
        for (p, imgs), r, want in zip(reqs, res, alone):
            _llava_same(single, p, imgs, r.tokens, want,
                        f"LLaVA batched ({'paged' if paged else 'slot'}) "
                        f"{'image' if imgs else 'text'} request against "
                        "single-stream")
        del single
        torch.cuda.empty_cache()
        _check(bc.get("K8" if paged else "K5", 0) > 0 and bc.get("K3", 0) > 0,
               f"LLaVA batched paged={paged}: launches {bc}")
        for k, v in bc.items():
            counts[k] = counts.get(k, 0) + v
        lines.append(f"{'paged (P = 64)' if paged else 'slot cache'} "
                     f"{secs:.2f} s, launches {bc}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"LLaVA-1.5-7B widths (CLIP ViT-L/14-336 f32, 23 of 24 layers; "
          f"LLaMA-2-7B q4_k_m, 32 layers; {card}): made on the card in "
          f"{made:.1f} s; image encode {enc_ms:.2f} ms (events, "
          f"{n_img} patches); prefill {t1.prompt_tokens} rows "
          f"{t1.prompt_time * 1e3:.1f} ms (the PNG's decode and the encode "
          f"inside); decode {t1.gen_tokens} tokens {t1.gen_tps:.1f} tok/s; "
          f"the first {LLAVA_PLAIN_DEPTH} tokens with the plain matmuls; "
          f"batched 2 image + 1 text requests x {LLAVA_BATCH_DEPTH} tokens "
          f"equal to single-stream: {'; '.join(lines)}; peak memory "
          f"{peak:.2f} GiB; launches of the single and batched runs "
          f"{counts}", flush=True)
    del model, clip
    torch.cuda.empty_cache()
    return counts


# whisper-small at full depth (synthetic weights on the card)
WHISPER_TOKENS = 32       # greedy tokens of the 30 s transcription
WHISPER_WINDOW_TOKENS = 16  # tokens a window of the 75 s one


def _speech(rng, seconds: float) -> np.ndarray:
    """A seeded signal: two gliding tones under an envelope, and noise."""
    t = np.arange(int(seconds * 16000)) / 16000
    f = 200 + 150 * np.sin(2 * np.pi * 0.1 * t)
    return (0.3 * np.sin(2 * np.pi * np.cumsum(f) / 16000)
            * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t))
            + 0.1 * np.sin(2 * np.pi * 1200 * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def phase_whisper(card: str) -> None:
    """whisper-small's widths at full depth (`synthetic_whisper`: 80 mels,
    d_model 768, 12 + 12 layers of 12 heads, ffn 3072, vocab 51865), f32 on
    the card: 30 s of seeded audio's encoder output and first decoder step's
    logits against the same module on the CPU (f32); `transcribe` of the
    30 s clip (greedy, WHISPER_TOKENS at most); `transcribe_verbose` of a
    75 s clip without timestamps (three windows, WHISPER_WINDOW_TOKENS a
    window, the full temperature ladder); one /api/extra/transcribe
    request through the port's app, equal to `transcribe`. Prints the
    encode ms, the ms of a decoder step and the window loop's seconds. No
    kernel of the TPU package is on this path (its products are einsums)."""
    import base64
    import io
    import wave

    from koboldcpp_tpu_torch.cli import NullEngine
    from koboldcpp_tpu_torch.models import whisper as tw
    from koboldcpp_tpu_torch.server.app import ServerSettings

    t0 = time.perf_counter()
    wm = synthetic_whisper(seed=0, device=DEV)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    cfg = wm.cfg
    rng = np.random.default_rng(23)
    clip30 = _speech(rng, 30.0)
    mel = tw.pad_or_trim_mel(tw.log_mel_spectrogram(clip30, cfg.n_mels))
    prompt = [cfg.sot_id, cfg.lang_en_id, cfg.transcribe_id,
              cfg.no_timestamps_id]
    cpu = tw.WhisperModel(cfg, _cpu_copy(wm.params), None,
                          torch.device("cpu"))
    enc = wm._encode(mel)
    enc_cpu = cpu._encode(mel)
    _close(enc, enc_cpu, "whisper-small encoder output (1500 x 768)")
    _close(torch.from_numpy(wm._last_logits(enc, prompt)),
           torch.from_numpy(cpu._last_logits(enc_cpu, prompt)),
           "whisper-small first decoder step's logits (51865)")
    del cpu, enc_cpu
    enc_ms = _event_ms(lambda: wm._encode(mel))
    step_ms = _event_ms(lambda: wm._last_logits(enc, prompt + [220] * 12))

    ts = time.perf_counter()
    text30 = wm.transcribe(clip30, max_tokens=WHISPER_TOKENS)
    t30 = time.perf_counter() - ts
    n30 = len(text30.split())
    _check(n30 <= WHISPER_TOKENS, f"whisper 30 s: {n30} tokens")
    windows = []
    orig = wm._decode_window

    def counted(enc_, prompt_, temp, *a):
        out = orig(enc_, prompt_, temp, *a)
        windows.append((temp, len(out[0])))
        return out

    wm._decode_window = counted
    clip75 = _speech(rng, 75.0)
    ts = time.perf_counter()
    try:
        r75 = wm.transcribe_verbose(clip75, max_tokens=WHISPER_WINDOW_TOKENS,
                                    with_timestamps=False)
    finally:
        del wm._decode_window
    t75 = time.perf_counter() - ts
    _check(len(r75["segments"]) == 3
           and r75["segments"][-1]["end"] == 75.0
           and all(n <= WHISPER_WINDOW_TOKENS for _, n in windows),
           f"whisper 75 s: segments {r75['segments']}, passes {windows}")

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((clip30[:16000 * 8] * 32767).astype(np.int16)
                      .tobytes())
    b64 = base64.b64encode(buf.getvalue()).decode()
    want = wm.transcribe(tw.decode_wav_base64(b64))
    srv = _Server(NullEngine(), ServerSettings(whisper_model=wm))
    try:
        got = srv.post("/api/extra/transcribe", {"audio_data": b64})
    finally:
        srv.close()
    _check(got == {"text": want}, f"whisper route: {got} vs {want!r}")
    print(f"whisper-small widths (f32, 12 + 12 layers, {card}): made on the "
          f"card in {made:.1f} s; encode {enc_ms:.2f} ms (events, 30 s "
          f"window); one decoder step at 16 tokens {step_ms:.2f} ms (events, "
          f"the full pass, last row projected); transcribe 30 s, {n30} "
          f"tokens: {t30:.2f} s; transcribe_verbose 75 s, 3 windows, "
          f"{len(windows)} passes (temperatures "
          f"{[t for t, _ in windows]}), {sum(n for _, n in windows)} tokens: "
          f"{t75:.2f} s; /api/extra/transcribe on an 8 s WAV equal to "
          f"transcribe", flush=True)
    del wm
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Stable Diffusion and the tools
# ---------------------------------------------------------------------------

# SD's outputs on the card against the same f32 module on the CPU:
# max |err| <= SD_TOL * max |want| (the convolutions take other algorithms
# on each side, true f32 on both)
SD_TOL = 1e-3
SD_PROMPT = "a lighthouse on a cliff at dusk, oil painting"


def _close_scale(got: torch.Tensor, want: torch.Tensor, what: str,
                 tol: float = SD_TOL) -> float:
    """Hold got (card) to want (CPU f32) within tol of want's largest
    magnitude; returns max |err| / (tol max |want|)."""
    g, w = got.float().cpu(), want.float()
    _check(g.shape == w.shape and bool(torch.isfinite(g).all()),
           f"{what}: shape {tuple(g.shape)} vs {tuple(w.shape)} or not finite")
    err, scale = float((g - w).abs().max()), float(w.abs().max())
    worst = err / (tol * scale)
    _check(worst <= 1.0, f"{what}: max |err| {err} > {tol} * {scale}")
    print(f"{what}: card against the CPU in f32, max abs err {err:.3g}, "
          f"max |want| {scale:.3g}, err / ({tol} max |want|) {worst:.3g}",
          flush=True)
    return worst


def _sd_cpu(m):
    from koboldcpp_tpu_torch.models import sd as tsd

    return tsd.SDModel(m.cfg, _cpu_copy(m.params), None, "cpu")


def _unet_call(m, x, t, cond, tids=None):
    from koboldcpp_tpu_torch.models import sd as tsd

    with tsd.true_f32(), torch.inference_mode():
        return m._unet(x, t, cond, tids)


def phase_sd(card: str) -> None:
    """SD 1.5's widths at full depth (`synthetic_sd`: `SDConfig`'s defaults,
    UNet 320 x (1, 2, 4, 4), 2 res blocks, 8 heads, context 768; the CLIP
    ViT-L/14 text tower 12 x 768; the VAE at 128 x (1, 2, 4, 4); 1.07 G
    f32 parameters drawn on the card): (a) the text encoding, one UNet
    evaluation at 32 x 32 latents, the VAE decode and encode of a 256 x
    256 image, each against the same module on the CPU (SD_TOL of the
    output's scale); (b) txt2img at 512 x 512, 20 steps, "Euler a", cfg 7
    (the route's defaults: 40 UNet evaluations) twice with one seed, the
    same bytes both times, timed; (c) img2img of that image at 512 x 512,
    denoise 0.75; (d) one /sdapi/v1/txt2img request over HTTP (4 steps),
    equal to txt2img with its arguments. Prints the seconds, ms per UNet
    evaluation at 64 x 64 latents and of the VAE decode at 512 x 512
    (events), peak memory. No kernel of the TPU package is on this path
    (its convolutions and einsums are XLA's)."""
    import base64
    import io

    from PIL import Image

    from koboldcpp_tpu_torch.cli import NullEngine
    from koboldcpp_tpu_torch.models import sd as tsd
    from koboldcpp_tpu_torch.models.synthetic import synthetic_sd
    from koboldcpp_tpu_torch.server.app import ServerSettings

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = synthetic_sd(seed=0, device=DEV)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    n_params = sum(v.numel() for v in m.params.values())
    cpu = _sd_cpu(m)
    rng = np.random.default_rng(31)
    cond = m.encode_prompt(SD_PROMPT)
    _close_scale(cond, cpu.encode_prompt(SD_PROMPT),
                 "SD 1.5 text encoding (77 x 768)")
    x = torch.from_numpy(rng.standard_normal((1, 4, 32, 32)).astype(
        np.float32))
    t = torch.tensor([500])
    _close_scale(_unet_call(m, x.to(DEV), t.to(DEV), cond),
                 _unet_call(cpu, x, t, cond.cpu()),
                 "SD 1.5 UNet, one evaluation at 32 x 32 latents")
    with tsd.true_f32(), torch.inference_mode():
        img = tsd.vae_decode(m.params, m.cfg, x.to(DEV))
        _close_scale(img, tsd.vae_decode(cpu.params, cpu.cfg, x),
                     "SD 1.5 VAE decode, 256 x 256")
        pic = img.clamp(-1, 1)
        _close_scale(tsd.vae_encode(m.params, m.cfg, pic),
                     tsd.vae_encode(cpu.params, cpu.cfg, pic.cpu()),
                     "SD 1.5 VAE encode, 256 x 256")
    del cpu
    kw = dict(width=512, height=512, steps=20, cfg_scale=7.0,
              sampler="Euler a", seed=42)
    a = m.txt2img(SD_PROMPT, **kw)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    b = m.txt2img(SD_PROMPT, **kw)
    torch.cuda.synchronize()
    t2i = time.perf_counter() - ts
    _check(a.shape == (512, 512, 3) and a.dtype == np.uint8
           and np.array_equal(a, b) and a.std() > 0,
           f"txt2img: {a.shape} {a.dtype}, repeat equal "
           f"{np.array_equal(a, b)}, std {a.std()}")
    ts = time.perf_counter()
    c = m.img2img(a, SD_PROMPT, denoise=0.75, steps=20, cfg_scale=7.0,
                  sampler="Euler a", seed=7)
    torch.cuda.synchronize()
    i2i = time.perf_counter() - ts
    _check(c.shape == (512, 512, 3) and not np.array_equal(c, a),
           f"img2img: {c.shape}")
    x64 = torch.randn((1, 4, 64, 64), device=DEV)
    unet_ms = _event_ms(lambda: _unet_call(m, x64, t.to(DEV), cond), reps=3)

    def decode():
        with tsd.true_f32(), torch.inference_mode():
            tsd.vae_decode(m.params, m.cfg, x64)
    vae_ms = _event_ms(decode, reps=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    body = {"prompt": SD_PROMPT, "steps": 4, "seed": 5}
    srv = _Server(NullEngine(), ServerSettings(sd_model=m))
    try:
        got = srv.post("/sdapi/v1/txt2img", body)["images"][0]
    finally:
        srv.close()
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(got))))
    want = m.txt2img(SD_PROMPT, steps=4, seed=5)
    _check(np.array_equal(got, want),
           f"/sdapi/v1/txt2img: {got.shape} differs from txt2img")
    print(f"SD 1.5 widths (f32, {n_params / 1e9:.3f} G parameters, "
          f"{card}): made on the card in {made:.1f} s; txt2img 512 x 512, 20 "
          f"steps, Euler a, cfg 7 (40 UNet evaluations + the VAE decode): "
          f"{t2i:.2f} s, the same bytes twice; one UNet evaluation at 64 x "
          f"64 latents {unet_ms:.2f} ms, the VAE decode at 512 x 512 "
          f"{vae_ms:.2f} ms (events); img2img 512 x 512, denoise 0.75: "
          f"{i2i:.2f} s; peak {peak:.2f} GiB; /sdapi/v1/txt2img (4 steps) "
          f"equal to txt2img", flush=True)
    del m
    torch.cuda.empty_cache()


def _taesd_state(seed: int) -> dict:
    """Random TAESD weights in the published taesd.py layout (encoder and
    decoder, 64 channels), N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    st = {}

    def conv(key, o, i, bias=True):
        st[key + ".weight"] = (rng.standard_normal((o, i, 3, 3)) * 0.05
                               ).astype(np.float32)
        if bias:
            st[key + ".bias"] = np.zeros(o, np.float32)

    def block(key):
        for j in (0, 2, 4):
            conv(f"{key}.conv.{j}", 64, 64)

    conv("encoder.0", 64, 3)
    for i in (1, 3, 4, 5, 7, 8, 9, 11, 12, 13):
        block(f"encoder.{i}")
    for i in (2, 6, 10):
        conv(f"encoder.{i}", 64, 64, bias=False)
    conv("encoder.14", 4, 64)
    conv("decoder.1", 64, 4)
    for i in (3, 4, 5, 8, 9, 10, 13, 14, 15, 18):
        block(f"decoder.{i}")
    for i in (7, 12, 17):
        conv(f"decoder.{i}", 64, 64, bias=False)
    conv("decoder.19", 3, 64)
    return st


def phase_sdxl(card: str) -> None:
    """stable-diffusion-xl-base-1.0's widths at full depth (`SDXL_BASE`:
    UNet 320 x (1, 2, 4), transformer depth (0, 2, 10) in heads of 64,
    linear projections, add_embedding 2816; CLIP-L 12 x 768 beside bigG 32
    x 1280 / 20 heads, pooled 1280, context 2048; 3.47 G f32 parameters
    drawn on the card): both towers and one UNet evaluation at 16 x 16
    latents against the same modules on the CPU; txt2img at 1024 x 1024,
    4 steps, cfg 5 (8 UNet evaluations at 128 x 128 latents); then TAESD
    (64 channels, random weights) decoding 32 x 32 latents against the
    CPU, and a 512 x 512 txt2img through it. Prints ms per UNet evaluation
    at 128 x 128 latents (events) and the seconds."""
    from koboldcpp_tpu_torch.models import sd as tsd
    from koboldcpp_tpu_torch.models import taesd as ttaesd
    from koboldcpp_tpu_torch.models.synthetic import SDXL_BASE, synthetic_sd

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = synthetic_sd(tsd.SDConfig(**SDXL_BASE), seed=1, device=DEV)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    n_params = sum(v.numel() for v in m.params.values())
    cpu = _sd_cpu(m)
    ctx, pooled = m.encode_prompt(SD_PROMPT)
    cctx, cpooled = cpu.encode_prompt(SD_PROMPT)
    _close_scale(ctx, cctx, "SDXL both towers' penultimate states (77 x 2048)")
    _close_scale(pooled, cpooled, "SDXL pooled bigG output (1280)")
    rng = np.random.default_rng(37)
    x = torch.from_numpy(rng.standard_normal((1, 4, 16, 16)).astype(
        np.float32))
    t = torch.tensor([700])
    tids = torch.tensor([[128.0, 128.0, 0.0, 0.0, 128.0, 128.0]])
    _close_scale(_unet_call(m, x.to(DEV), t.to(DEV), (ctx, pooled),
                            tids.to(DEV)),
                 _unet_call(cpu, x, t, (cctx, cpooled), tids),
                 "SDXL UNet, one evaluation at 16 x 16 latents")
    del cpu
    ts = time.perf_counter()
    img = m.txt2img(SD_PROMPT, width=1024, height=1024, steps=4,
                    cfg_scale=5.0, sampler="Euler a", seed=3)
    torch.cuda.synchronize()
    t2i = time.perf_counter() - ts
    _check(img.shape == (1024, 1024, 3) and img.std() > 0,
           f"SDXL txt2img: {img.shape}")
    x128 = torch.randn((1, 4, 128, 128), device=DEV)
    tids128 = torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]],
                           device=DEV)
    unet_ms = _event_ms(lambda: _unet_call(m, x128, t.to(DEV),
                                           (ctx, pooled), tids128), reps=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = _taesd_state(5)
    m.set_taesd(st)
    cpu_taesd = ttaesd.load_taesd(st, device="cpu")
    z = torch.from_numpy(rng.standard_normal((1, 4, 32, 32)).astype(
        np.float32))
    with tsd.true_f32(), torch.inference_mode():
        _close_scale(ttaesd.decoder_apply(m.taesd, z.to(DEV)),
                     ttaesd.decoder_apply(cpu_taesd, z),
                     "TAESD decode of 32 x 32 latents (256 x 256)")
    ts = time.perf_counter()
    timg = m.txt2img(SD_PROMPT, width=512, height=512, steps=4,
                     cfg_scale=5.0, seed=3)
    torch.cuda.synchronize()
    t_taesd = time.perf_counter() - ts
    _check(timg.shape == (512, 512, 3), f"SDXL + TAESD: {timg.shape}")
    print(f"SDXL base widths (f32, {n_params / 1e9:.3f} G parameters, "
          f"{card}): made on the card in {made:.1f} s; txt2img 1024 x 1024, "
          f"4 steps, Euler a, cfg 5 (8 UNet evaluations + the VAE decode): "
          f"{t2i:.2f} s; one UNet evaluation at 128 x 128 latents "
          f"{unet_ms:.2f} ms (events); peak {peak:.2f} GiB; txt2img 512 x "
          f"512, 4 steps, TAESD decode: {t_taesd:.2f} s", flush=True)
    del m
    torch.cuda.empty_cache()


# the tools' text (the tiny fixture's vocabulary) and windows
TOOLS_TEXT = " ".join(f"word{i % 37} part{(i * 7) % 53} of the story"
                      for i in range(120))
TOOLS_CTX = 64
PPL_WINDOWS = 4   # windows of PPL_CTX rows of the 1.1B run
PPL_CTX = 512
PPL_TOL = 1e-2    # relative, perplexity on the card against the CPU / plain


def phase_tools(card: str) -> dict:
    """The perplexity and imatrix tools (`koboldcpp_tpu_torch/tools/`): on
    the tiny Q4_K_M fixture, perplexity over four 64-token windows and
    imatrix's mean squares over two, card against CPU (PPL_TOL relative;
    imatrix within 1e-3 of each tensor's largest value, f32 both sides);
    then perplexity over PPL_WINDOWS windows of PPL_CTX on the synthetic
    1.1B, each window one forward from position 0 through K3 (22 x 4
    packed projections and the head a window) and K4 (22 a window), held
    against the same windows with the kernels' plain versions on the card.
    Returns the launch counts of the 1.1B run."""
    from koboldcpp_tpu_torch.tools import imatrix as timatrix
    from koboldcpp_tpu_torch.tools import perplexity as tppl

    path = os.path.join(FIX, "tiny-q4_k_m.gguf")
    got = tppl.perplexity(load_model(path, device=DEV), TOOLS_TEXT,
                          n_ctx=TOOLS_CTX, verbose=False)
    want = tppl.perplexity(load_model(path, device="cpu"), TOOLS_TEXT,
                           n_ctx=TOOLS_CTX, verbose=False)
    _check(abs(got - want) <= PPL_TOL * want,
           f"perplexity on the fixture: card {got} against CPU {want}")
    ig = timatrix.collect(path, TOOLS_TEXT, TOOLS_CTX, 2, device=DEV)
    iw = timatrix.collect(path, TOOLS_TEXT, TOOLS_CTX, 2, device="cpu")
    worst = max(float(np.abs(ig[k] - v).max() / (1e-3 * np.abs(v).max()))
                for k, v in iw.items())
    _check(set(ig) == set(iw) and worst <= 1.0,
           f"imatrix on the fixture: card against CPU, worst {worst}")
    model = synthetic_model(TINYLLAMA_1_1B, "q4_k", seed=0, device=DEV)
    rng = np.random.default_rng(41)
    toks = rng.integers(3, TINYLLAMA_1_1B.vocab_size,
                        size=PPL_WINDOWS * PPL_CTX).tolist()
    _build.launches.clear()
    ts = time.perf_counter()
    ppl = tppl.perplexity(model, toks, n_ctx=PPL_CTX, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - ts
    counts = dict(_build.launches)
    with _plain_matmuls(), mock.patch.object(
            llama, "flash_prefill_attention", flash_prefill.flash_prefill_plain):
        plain = tppl.perplexity(model, toks, n_ctx=PPL_CTX, verbose=False)
    _check(abs(ppl - plain) <= PPL_TOL * plain and math.isfinite(ppl),
           f"1.1B perplexity {ppl} against the plain versions' {plain}")
    _check(counts.get("K3", 0) >= PPL_WINDOWS * 22 * 4
           and counts.get("K4", 0) == PPL_WINDOWS * 22,
           f"1.1B perplexity launches {counts}")
    print(f"tools ({card}): perplexity of the tiny fixture, 4 windows of "
          f"{TOOLS_CTX}: card {got:.6f}, CPU {want:.6f}; imatrix, 2 windows: "
          f"{len(ig)} tensors, worst |err| / (1e-3 max) {worst:.3g}; the "
          f"synthetic 1.1B, {PPL_WINDOWS} windows of {PPL_CTX}: perplexity "
          f"{ppl:.4f} (the plain versions' {plain:.4f}) in {secs:.2f} s; "
          f"launches {counts}", flush=True)
    del model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the recurrent, embedding and encoder-decoder models
# ---------------------------------------------------------------------------

TEXT_DEPTH = 8    # greedy tokens of each full-width generator phase
TEXT_PLAIN_DEPTH = 4  # of them, under the kernels' plain versions
TEXT_PROMPT = 300  # prompt tokens (T5: the encoder's input)
# greedy tokens of each profiled window (the host loop: a forward a token)
TEXT_PROFILE_DEPTH = 4
# the full-width models (models/synthetic.py, every one at its published
# depth) and the kernels each one's main path must launch: q4_k
# projections K1 at T = 1 and K3 in the prefill / encoder chunks, a q6_k
# head K2 (rwkv6's); RWKV-4's q8_0 .bin K2.q8_0 / K3.q8_0; Mamba's tied
# head, the declined small projections and flan-T5's 32128-row head take
# the dequant path, as in JAX
TEXT_MODELS = (
    ("Mamba-1.4B", MAMBA_1_4B_MD, ("K1", "K3")),
    ("RWKV6 Finch 1.6B", RWKV6_FINCH_1B6_MD, ("K1", "K2", "K3")),
    ("RWKV-4-Pile-1B5", RWKV4_PILE_1B5_MD, ("K2.q8_0", "K3.q8_0")),
    ("nomic-embed-text-v1.5", NOMIC_EMBED_V1_5_MD, ("K3",)),
    ("flan-t5-base", FLAN_T5_BASE_MD, ("K1", "K3")),
)
TEXT_FIXTURE_KERNELS = {"mamba": ("K1", "K3"), "rwkv6": ("K1", "K3"),
                        "rwkv4": ("K2.q8_0", "K3.q8_0"),
                        "nomic-bert": ("K3",), "t5": ("K1", "K3")}


def _text_run(eng: Engine, prompt, gp):
    """One request: (tokens, timings, launches)."""
    _build.launches.clear()
    r = eng.generate(prompt, gp)
    return r.tokens, r.timings, dict(_build.launches)


def _text_same(eng: Engine, prompt, got, want, what) -> None:
    """got == want, or equal up to a step where the two picks' logits lie
    within NEAR_TIE (T5: the decoder's logits after a fresh encoder
    pass)."""
    if not eng.encdec:
        return _same_or_near_tie(eng, prompt, got, want, what)
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    _check(i is not None, f"{what}: one reply stopped early: {got} {want}")
    eng._run_encoder(list(prompt))
    dec = [eng.cfg.extras.get("decoder_start", 0)] + got[:i]
    lg = eng._forward(torch.tensor([dec], device=DEV),
                      torch.arange(len(dec), device=DEV)[None],
                      last_only=True)[0, -1].float()
    a, b = lg[got[i]].item(), lg[want[i]].item()
    _check(abs(a - b) <= NEAR_TIE,
           f"{what}: tokens part at step {i} ({got[i]} vs {want[i]}), "
           f"logits {a} vs {b}")
    print(f"near-tie: {what}, step {i}: tokens {got[i]} / {want[i]}, "
          f"logits {a:.6f} / {b:.6f}", flush=True)


def _no_kernel_ms(model) -> tuple[float, str]:
    """The device time alone at T = 1 of the projections the dispatch
    declines (the dequant path, as in JAX; dense bf16 weights too), summed
    over the model, and which they are."""
    from koboldcpp_tpu_torch.ops import linear as tlinear

    layers = (model.params.get("layers") or model.params.get("dec_layers")
              or [])

    def declined(v):  # the dispatch's shape rule (ops/quant_matmul.py)
        return v.kind == "dense" or v.shape[0] % 256 or v.shape[1] % 256

    keys = sorted({k for ly in layers for k, v in ly.items()
                   if isinstance(v, QTensor) and declined(v)})
    total, names = 0.0, []
    # inference mode: an earlier phase may have made _dev_ms's flush
    # buffer inside it, and such a tensor is written only there
    with torch.inference_mode():
        for k in keys:
            v = layers[0][k]
            x = torch.randn(1, v.shape[1], device=DEV).bfloat16()
            ms = _dev_ms(lambda: tlinear.matmul(x, v))
            total += len(layers) * ms
            names.append(f"{k} {tuple(v.shape)} {ms:.4f} ms x {len(layers)}")
        head = model.params.get("output")
        if head is not None and declined(head):
            x = torch.randn(1, head.shape[1], device=DEV).bfloat16()
            ms = _dev_ms(lambda: tlinear.matmul(x, head,
                                                out_dtype=torch.float32))
            total += ms
            names.append(f"head {tuple(head.shape)} {head.kind} {ms:.4f} ms")
    return total, "; ".join(names) or "none"


def _scan_ms(model) -> str:
    """The recurrence's device time alone for one layer at T = 1 (a decode
    step) and over a 300-row prefill chunk (bucket 512), on state-shaped
    random inputs, times the depth."""
    from koboldcpp_tpu_torch.models import mamba as tmamba
    from koboldcpp_tpu_torch.models import rwkv4 as trwkv4
    from koboldcpp_tpu_torch.models import rwkv6 as trwkv6

    cfg, L = model.cfg, model.cfg.n_layers
    gen = torch.Generator(device=DEV).manual_seed(3)
    out = []
    for T, n in ((1, 1), (512, TEXT_PROMPT)):
        valid = torch.arange(T, device=DEV)[None] < n
        scan = (n, False)

        def u(*shape, lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand(shape, device=DEV,
                                               generator=gen)

        if cfg.arch == "mamba":
            d, N = cfg.ssm_d_inner, cfg.ssm_d_state
            h = torch.zeros(1, d, N, device=DEV)
            args = (u(1, T, d, N, lo=0.5), u(1, T, d, N, hi=0.01),
                    u(1, T, N), h)
            fn = lambda: tmamba.selective_scan(*args, valid, scan)  # noqa
        elif cfg.arch == "rwkv6":
            H, D = cfg.n_heads, cfg.head_dim
            S = torch.zeros(1, H, D, D, device=DEV)
            r, k, v = (u(1, T, H, D, lo=-1) for _ in range(3))
            w = u(1, T, H, D, lo=0.5)
            first = u(H, D)
            fn = lambda: trwkv6.wkv_scan(r, k, v, w, first, S, valid,  # noqa
                                         scan)
        else:
            C = cfg.hidden_size
            k, v = u(1, T, C, lo=-1), u(1, T, C, lo=-1)
            first, decay = u(C), -u(C, lo=0.1)
            acc = [torch.zeros(1, C, device=DEV) for _ in range(2)]
            pp = torch.full((1, C), -1e30, device=DEV)
            fn = lambda: trwkv4.wkv4_scan(k, v, first, decay, *acc,  # noqa
                                          pp, valid, scan)
        with torch.inference_mode():  # as in _no_kernel_ms
            ms = _dev_ms(fn)
        out.append(f"T = {T} ({n} rows) {ms:.4f} ms a layer, "
                   f"{L * ms:.3f} ms the {L} layers")
    return "; ".join(out)


def phase_text_decode(card: str, name: str, md: dict,
                      kernels: tuple) -> tuple[dict, Model]:
    """A full-width recurrent or encoder-decoder model (`name`'s published
    widths, `synthetic_text_model`) through Engine: a TEXT_PROMPT-token
    prompt (one 512-row chunk through K3; T5: the encoder's chunk) and
    TEXT_DEPTH greedy tokens in the host loop, each a one-row step (K1 /
    K2), twice with the same tokens (a recurrent state resets for a prompt
    that does not extend its context, T5 decodes fresh), the first
    TEXT_PLAIN_DEPTH of them under the plain versions of K1 / K2 / K3
    (near-ties apart); a recurrent
    model then continues its cached state by one prompt token. Prints
    decode tok/s, prefill ms, the launches, the recurrence's device time
    alone (a layer at T = 1 and over the prompt) and the dequant-path
    projections'. Returns (launches, the model)."""
    t0 = time.perf_counter()
    model = synthetic_text_model(md, seed=0, device=DEV)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    cfg = model.cfg
    eng = Engine(model, max_context=2048, device=DEV)
    _check((eng.recurrent or eng.encdec) and not eng.use_flash_prefill,
           f"{name}: the engine did not take its branch")
    rng = np.random.default_rng(9)
    prompt = [1] + rng.integers(3, cfg.vocab_size,
                                size=TEXT_PROMPT - 1).tolist()
    sampler = SamplerParams(temperature=0.0, rep_pen=1.0)
    gp = GenParams(max_length=TEXT_DEPTH, bypass_eos=True, sampler=sampler)
    eng.generate(prompt, GenParams(max_length=2, bypass_eos=True,
                                   sampler=sampler))  # warm-up
    toks, t1, counts = _text_run(eng, prompt, gp)
    _check(len(toks) == TEXT_DEPTH
           and all(0 <= t < cfg.vocab_size for t in toks),
           f"{name}: tokens {toks}")
    again, t2, c2 = _text_run(eng, prompt, gp)
    _check(again == toks, f"{name}: greedy decode not repeatable: "
           f"{again} {toks}")
    with _plain_matmuls():
        plain, _, cp = _text_run(eng, prompt, GenParams(
            max_length=TEXT_PLAIN_DEPTH, bypass_eos=True, sampler=sampler))
    _check(not any(cp.get(k, 0) for k in kernels),
           f"{name}: the plain run launched {cp}")
    _text_same(eng, prompt, plain, toks[:TEXT_PLAIN_DEPTH],
               f"{name}, {' / '.join(kernels)} against their plain versions")
    for k, v in c2.items():
        counts[k] = counts.get(k, 0) + v
    ff = ""
    if eng.recurrent:
        _build.launches.clear()
        eng.generate(list(eng.context_tokens) + [7], GenParams(
            max_length=4, bypass_eos=True, sampler=sampler))
        for k, v in _build.launches.items():
            counts[k] = counts.get(k, 0) + v
        _check(eng.last_timings.prompt_tokens == 1,
               f"{name}: a continuation evaluated "
               f"{eng.last_timings.prompt_tokens} prompt tokens")
        ff = "; a continuation of the cached state evaluated 1 prompt token"
    _check(all(counts.get(k, 0) > 0 for k in kernels),
           f"{name}: launches {counts}, wanted {kernels}")
    no_kernel, which = _no_kernel_ms(model)
    scan = _scan_ms(model) if eng.recurrent else "none (no recurrence)"
    layers = len(model.params.get("layers") or model.params["dec_layers"])
    print(f"{name} ({cfg.arch}, hidden {cfg.hidden_size}, {layers} layers"
          + (f" + {layers} encoder layers" if eng.encdec else "")
          + f", vocab {cfg.vocab_size}; {card}): synthetic weights "
          f"{made:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; prefill "
          f"{t1.prompt_tokens} tokens {t1.prompt_time * 1e3:.1f} ms"
          + (f" (the encoder's {TEXT_PROMPT} rows and the decoder's start "
             f"token)" if eng.encdec else "")
          + f", again {t2.prompt_time * 1e3:.1f} ms; decode "
          f"{t1.gen_tokens} tokens {t1.gen_tps:.2f} tok/s, again "
          f"{t2.gen_tps:.2f}; repeatable, the same tokens with the plain "
          f"versions (near-ties apart){ff}; launches {counts}", flush=True)
    print(f"{name} device time alone: the recurrence {scan}; the "
          f"dequant-path projections {no_kernel:.4f} ms a token ({which})",
          flush=True)
    del eng
    return counts, model


def phase_embed(card: str, name: str, md: dict,
                kernels: tuple) -> tuple[dict, Model]:
    """A full-width embedding model through Engine.embed: one text through
    the entry point, then the encoder over TEXT_PROMPT token ids (one
    512-row chunk: every projection through K3) pooled as `embed` pools,
    timed, and the same embeddings with K3's plain version (|err| <= 2e-2
    + 2e-2 |want|). Returns (launches, the model)."""
    from koboldcpp_tpu_torch.models import bert as tbert

    t0 = time.perf_counter()
    model = synthetic_text_model(md, seed=0, device=DEV)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    cfg = model.cfg
    eng = Engine(model, max_context=2048, device=DEV)
    _check(eng.embedding and eng.cache is None,
           f"{name}: the engine did not take the embedding branch")
    _build.launches.clear()
    v = eng.embed(["the entry point's text"])
    counts = dict(_build.launches)
    _check(v.shape == (1, cfg.hidden_size) and np.isfinite(v).all(),
           f"{name}: embed gave {v.shape}")
    rng = np.random.default_rng(9)
    ids = [1] + rng.integers(3, cfg.vocab_size,
                             size=TEXT_PROMPT - 1).tolist()
    tok, pos = eng._end_padded(ids)

    def encode():
        with torch.inference_mode():
            h = tbert.forward_embed(model.params, cfg, tok, pos)
            return tbert.pool(h, pos, "mean")

    _build.launches.clear()
    got = encode()
    for k, n in _build.launches.items():
        counts[k] = counts.get(k, 0) + n
    with _plain_matmuls():
        want = encode()
    diff = (got - want).abs()
    worst = float((diff / (2e-2 + 2e-2 * want.abs())).max())
    _check(worst <= 1.0 and bool(torch.isfinite(got).all()),
           f"{name}: embeddings off the plain versions' by {worst}")
    ms = _event_ms(encode)
    _check(all(counts.get(k, 0) > 0 for k in kernels),
           f"{name}: launches {counts}, wanted {kernels}")
    no_kernel, which = _no_kernel_ms(model)
    print(f"{name} ({cfg.arch}, hidden {cfg.hidden_size}, {cfg.n_layers} "
          f"layers, vocab {cfg.vocab_size}; {card}): synthetic weights "
          f"{made:.1f} s; an encode of {TEXT_PROMPT} tokens (bucket "
          f"{tok.shape[1]}) {ms:.2f} ms (events), {TEXT_PROMPT / ms * 1e3:.0f}"
          f" tokens/s; pooled embeddings against K3's plain version: max "
          f"abs err {float(diff.max()):.4g}, worst |err| / (2e-2 + 2e-2 "
          f"|want|) {worst:.3g}; launches {counts}; dequant-path "
          f"projections {no_kernel:.4f} ms ({which})", flush=True)
    del eng
    return counts, model


def phase_text_profiled(card: str, models: dict) -> None:
    """Last: the device idle share under torch.profiler of each full-width
    text model's host loop: a recurrent model continuing its cached state
    (one prompt token, then TEXT_PROFILE_DEPTH greedy tokens), T5 a
    request (the encoder's TEXT_PROMPT rows, then TEXT_PROFILE_DEPTH
    tokens), the embedding model an encode of TEXT_PROMPT tokens."""
    from koboldcpp_tpu_torch.models import bert as tbert

    sampler = SamplerParams(temperature=0.0, rep_pen=1.0)
    rng = np.random.default_rng(9)
    for name, model in models.items():
        eng = Engine(model, max_context=2048, device=DEV)
        prompt = [1] + rng.integers(3, model.cfg.vocab_size,
                                    size=TEXT_PROMPT - 1).tolist()
        gp = GenParams(max_length=TEXT_PROFILE_DEPTH, bypass_eos=True,
                       sampler=sampler)
        if eng.embedding:
            tok, pos = eng._end_padded(prompt)

            def run():
                with torch.inference_mode():
                    tbert.forward_embed(model.params, model.cfg, tok, pos)
        elif eng.recurrent:
            eng.generate(prompt, GenParams(max_length=8, bypass_eos=True,
                                           sampler=sampler))

            def run():
                eng.generate(list(eng.context_tokens) + [7], gp)
        else:
            eng.generate(prompt, GenParams(max_length=8, bypass_eos=True,
                                           sampler=sampler))

            def run():
                eng.generate(prompt, gp)
        print(f"profiled {name} ({card}): {_idle_share(run)}"
              + ("" if eng.embedding else
                 f"; decode {eng.last_timings.gen_tps:.2f} tok/s under the "
                 f"profiler"), flush=True)
        del eng


def phase_served_text() -> dict:
    """The tiny text fixtures (tests/fixtures/portgguf/text.json: Mamba and
    RWKV6 at Q4_K_M, RWKV-4 as a q8_0 legacy .bin beside its vocab, the
    nomic-bert and T5 Q4_K_M files) served over HTTP at temperature 0: two
    identical /api/v1/generate replies from each generator, one
    /v1/embeddings call (and a 400 on generate) for nomic-bert, each
    fixture's kernels launched; then their numbers on the card (the
    generators' logits, nomic-bert's hidden states; T5's decoder logits
    after its encoder) against the JAX package's committed ones, |err| <=
    2e-2 + 2e-2 |want|."""
    from urllib.error import HTTPError

    from koboldcpp_tpu_torch.models import bert as tbert
    from koboldcpp_tpu_torch.models import t5 as tt5
    from koboldcpp_tpu_torch.models.loader import arch_module
    from koboldcpp_tpu_torch.server.app import ServerSettings

    man = json.load(open(os.path.join(PORT_FIX, "text.json")))
    tokens = man["tokens"]
    body = {"prompt": "The gradient of a function, e.g. f(x), points",
            "max_length": 24, "temperature": 0, "rep_pen": 1.0}
    counts: dict = {}
    for arch, name in man["files"].items():
        path = os.path.join(PORT_FIX, name)
        model = load_model(path, device=DEV)
        eng = Engine(model, max_context=512, device=DEV)
        srv = _Server(eng, ServerSettings(model_name=name))
        try:
            _build.launches.clear()
            if eng.embedding:
                d = srv.post("/v1/embeddings", {"input": ["Once upon",
                                                          "a time"]})
                vec = np.array([e["embedding"] for e in d["data"]])
                _check(vec.shape == (2, model.cfg.hidden_size)
                       and np.isfinite(vec).all(),
                       f"{name}: /v1/embeddings gave {vec.shape}")
                try:
                    srv.post("/api/v1/generate", body)
                    status = 200
                except HTTPError as e:
                    status = e.code
                _check(status == 400, f"{name}: generate answered {status}")
                reply = f"/v1/embeddings {vec.shape}, generate 400"
            else:
                a, b = (srv.post("/api/v1/generate", body)["results"][0][
                    "text"] for _ in range(2))
                _check(a == b and a != "",
                       f"{name}: temperature-0 replies differ: {a!r} {b!r}")
                reply = f"/api/v1/generate x2 identical ({a!r})"
            c = dict(_build.launches)
        finally:
            srv.close()
        _check(all(c.get(k, 0) > 0 for k in TEXT_FIXTURE_KERNELS[arch]),
               f"{name}: launches {c}")
        m32 = load_model(path, dtype=torch.float32, device=DEV)
        toks = torch.tensor([tokens], device=DEV)
        pos = torch.arange(len(tokens), device=DEV)[None]
        with torch.inference_mode():
            if arch == "nomic-bert":
                got = tbert.forward_embed(m32.params, m32.cfg, toks, pos)
            elif arch == "t5":
                e = tt5.encode(m32.params, m32.cfg, toks, pos)
                cache = tt5.prepare_cross(
                    m32.params, m32.cfg, e, pos >= 0,
                    tt5.init_cache(m32.cfg, 1, 64, len(tokens), device=DEV))
                dec = torch.tensor([[m32.cfg.extras["decoder_start"]]
                                    + tokens[:-1]], device=DEV)
                got, _ = tt5.forward(m32.params, m32.cfg, dec, pos, cache)
            else:
                mod = arch_module(arch)
                got, _ = mod.forward(m32.params, m32.cfg, toks, pos,
                                     mod.init_state(m32.cfg, 1, device=DEV))
        got = got[0].float().cpu().numpy()
        want = np.load(os.path.join(PORT_FIX, man["numbers"][arch]))
        diff = np.abs(got - want)
        worst = float((diff / (2e-2 + 2e-2 * np.abs(want))).max())
        _check(worst <= 1.0, f"{name} off the JAX numbers: |err| / (2e-2 + "
               f"2e-2 |want|) {worst}")
        print(f"served {name}: {reply}; numbers vs the JAX package's: max "
              f"abs err {float(diff.max()):.4g}, worst |err| / (2e-2 + 2e-2 "
              f"|want|) {worst:.3g}; launches {c}", flush=True)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts


# ---------------------------------------------------------------------------
# parallel serving: two ranks on this one card over gloo
# ---------------------------------------------------------------------------

# greedy tokens of each parallel form's reply
PAR_TOKENS = 32
PAR_FORMS = ("tp", "pp", "sp")
PAR_KERNELS = ("K1", "K2", "K3", "K4", "K5")
# the 1.1B's weights a tp=2 shard keeps whole on both ranks (their 128-row
# shards would break the packed kernels' dispatch rule): wk and wv (4 kv
# heads of 64), each layer; every other weight is a shard
PAR_KEPT_WHOLE = {"wk": "Sliced", "wv": "Sliced"}


# phase_parallel's tp=2 cases of the other model modules: the depth of the
# two large models cut (printed) to keep the script within its limit
TP_DS2_LAYERS = 3     # DeepSeek-V2-Lite: the dense lead layer, 2 MoE layers
TP_RWKV6_LAYERS = 6   # RWKV6 Finch 1.6B: 6 of its 24 layers
TP_ARCH_TOKENS = 8    # greedy tokens of each reply
TP_ARCH_PROMPT = 300  # prompt tokens
TP_TEXTS = ["the entry point's text", "a second text of a few more words"]
TP_EMBED_TOL = 4e-2   # tests/test_torch_parallel_archs.py's packed shards
TP_FIXTURES = {a: f"tiny-{a}-q4_k_m.gguf" for a in (
    "bitnet", "openelm", "chameleon_swin", "mpt", "jais", "plamo")}


def _tp_models():
    """(label, the model's maker, kernels its tp=2 run must launch on each
    rank) of phase_parallel's cases beyond the 1.1B: the large models from
    seed 0 on the card (each rank draws the same weights), the fixtures
    from tests/fixtures/portgguf (hidden 256: K1 / K3 on the shards that
    meet the rule, the rest kept whole)."""
    yield ("DeepSeek-V2-Lite", lambda: synthetic_deepseek2_model(
        dict(DEEPSEEK_V2_LITE_MD, **{"deepseek2.block_count": TP_DS2_LAYERS}),
        seed=0, device=DEV), ("K1", "K2", "K3"))
    yield ("RWKV6 Finch 1.6B", lambda: synthetic_text_model(
        dict(RWKV6_FINCH_1B6_MD, **{"rwkv6.block_count": TP_RWKV6_LAYERS}),
        seed=0, device=DEV), ("K1", "K2", "K3"))
    yield ("nomic-embed-text-v1.5", lambda: synthetic_text_model(
        NOMIC_EMBED_V1_5_MD, seed=0, device=DEV), ("K3",))
    for arch, f in TP_FIXTURES.items():
        yield (f"tiny {arch}", lambda f=f: load_model(
            os.path.join(PORT_FIX, f), device=DEV), ("K1", "K3"))


def _tp_archs(rank: int, world, devs) -> dict:
    """Both ranks' side of phase_parallel's tp=2 cases of `_tp_models`:
    rank 0 serves a request (a TP_ARCH_PROMPT-token prompt and
    TP_ARCH_TOKENS greedy tokens; the embedding model TP_TEXTS) through
    the unsharded engine, then both ranks build the tp=2 shard and rank 0
    drives the same request through the step mirror. Returns per case
    this rank's launches, the dequantized shapes that meet the kernels'
    256 rule (none may), the weights kept whole, and rank 0's check."""
    from koboldcpp_tpu_torch.ops import linear as linear_ops
    from koboldcpp_tpu_torch.parallel import launch
    from koboldcpp_tpu_torch.parallel.sharding import (KeptWhole, make_mesh,
                                                       shard_model)

    mesh = make_mesh(dp=1, tp=2, devices=devs)
    real_dequant = linear_ops.dequant
    res = {}
    for label, build, kernels in _tp_models():
        t0 = time.perf_counter()
        model = build()
        torch.cuda.synchronize()
        r = {"build_s": time.perf_counter() - t0, "kernels": list(kernels)}
        cfg = model.cfg
        prompt = [1] + np.random.default_rng(5).integers(
            3, cfg.vocab_size, size=TP_ARCH_PROMPT - 1).tolist()
        gp = GenParams(max_length=TP_ARCH_TOKENS, bypass_eos=True,
                       sampler=SamplerParams(temperature=0.0, rep_pen=1.0))

        def serve(eng):
            if cfg.is_embedding:
                return torch.from_numpy(eng.embed(TP_TEXTS))
            return eng.generate(prompt, gp).tokens
        single = None
        if rank == 0:
            single = Engine(model, max_context=2048, device=DEV)
            t1 = time.perf_counter()
            want = serve(single)
            r["single_ms"] = (time.perf_counter() - t1) * 1e3
        shard = shard_model(model, mesh)
        r["kept"] = sorted({k for layer in shard.params.get("layers", [])
                            for k, w in layer.items()
                            if isinstance(w, KeptWhole)})
        eng = Engine(shard, max_context=2048, device=DEV)
        rule = []

        def counted(qt, *a, **kw):
            if qt.shape[0] % 256 == 0 and qt.shape[1] % 256 == 0:
                rule.append(list(qt.shape))
            return real_dequant(qt, *a, **kw)
        torch.cuda.synchronize()
        _build.launches.clear()
        with mock.patch.object(linear_ops, "dequant", counted):
            if rank == 0:
                launch.mirror(eng, world, eng.MIRRORED_STEPS)
                t1 = time.perf_counter()
                got = serve(eng)
                r["tp_ms"] = (time.perf_counter() - t1) * 1e3
                launch.stop(eng)
            else:
                launch.follow(eng, world)
        torch.cuda.synchronize()
        r["counts"] = dict(_build.launches)
        r["rule_dequant"] = rule
        if rank == 0:
            if cfg.is_embedding:
                err = (got - want).abs()
                worst = float((err / (TP_EMBED_TOL + TP_EMBED_TOL
                                      * want.abs())).max())
                _check(worst <= 1.0 and bool(torch.isfinite(got).all()),
                       f"{label} tp=2 embeddings: worst {worst} of "
                       f"{TP_EMBED_TOL} + {TP_EMBED_TOL} |want|")
                r["check"] = (f"embeddings max abs err "
                              f"{float(err.max()):.4g}, worst {worst:.3g} "
                              f"of the tolerance")
            else:
                _check(len(got) == TP_ARCH_TOKENS,
                       f"{label} tp=2: {len(got)} tokens")
                _same_or_near_tie(single, prompt, got, want,
                                  f"{label} tp=2 reply")
                r["check"] = ("the unsharded tokens" if got == want
                              else "the unsharded tokens up to a near-tie")
        del eng, shard, single, model
        torch.cuda.empty_cache()
        res[label] = r
    return res


def _parallel_forms(rank: int, init: str, prompt: list[int]) -> dict:
    """Both ranks' side of phase_parallel: a gloo group of two processes
    on cuda:0 (NCCL refuses two ranks on one device, so gloo is asked for
    here), then for each form the TinyLlama-1.1B Q4_K_M model drawn on the
    card from seed 0 (the same weights in both processes), sharded over
    tp=2, staged over pp=2 or its context over sp=2, and one greedy
    request that rank 0 drives through the step mirror and rank 1
    follows. Returns this rank's {form: launch counts, dequant calls}
    and rank 0's replies and times, then the tp=2 cases of the other model
    modules (`_tp_archs`)."""
    import torch.distributed as dist

    from koboldcpp_tpu_torch.ops import linear as linear_ops
    from koboldcpp_tpu_torch.parallel import comm, launch
    from koboldcpp_tpu_torch.parallel.sharding import (KeptWhole, Mesh,
                                                       make_mesh, shard_model)

    comm.init("gloo", init, 2, rank)
    world = comm.world_group()
    devs = [DEV, DEV]
    out: dict = {"counts": {}, "dequant": {}, "tokens": {}, "ms": {}}
    dq = {"n": 0}
    real_dequant = linear_ops.dequant

    def counted(*a, **kw):
        dq["n"] += 1
        return real_dequant(*a, **kw)

    for form in PAR_FORMS:
        model = synthetic_q4_k_m_on_device(TINYLLAMA_1_1B, seed=0, device=DEV)
        kw = {}
        if form == "tp":
            mesh = make_mesh(dp=1, tp=2, devices=devs)
            model = shard_model(model, mesh)
            _check(not isinstance(model.params["output"], KeptWhole),
                   "the tp=2 head is kept whole")
            for li, layer in enumerate(model.params["layers"]):
                kept = {k: type(w).__name__ for k, w in layer.items()
                        if isinstance(w, KeptWhole)}
                _check(kept == PAR_KEPT_WHOLE,
                       f"layer {li}: kept whole {kept}, not {PAR_KEPT_WHOLE}")
                for k, w in layer.items():
                    if isinstance(w, QTensor) and w.kind != "dense":
                        _check(w.shape[0] % 256 == 0 and w.shape[1] % 256 == 0,
                               f"layer {li}: tp shard {k} {w.shape} breaks "
                               "the dispatch rule")
        else:
            kw[f"{form}_mesh"] = Mesh({form: 2}, devs)
        eng = Engine(model, max_context=2048, device=DEV, **kw)
        torch.cuda.synchronize()
        _build.launches.clear()
        dq["n"] = 0
        with mock.patch.object(linear_ops, "dequant", counted):
            if rank == 0:
                launch.mirror(eng, world, eng.MIRRORED_STEPS)
                r = eng.generate(prompt, GenParams(
                    max_length=PAR_TOKENS, bypass_eos=True,
                    sampler=SamplerParams(temperature=0.0, rep_pen=1.0)))
                launch.stop(eng)
                t = eng.last_timings
                out["tokens"][form] = r.tokens
                out["ms"][form] = (t.prompt_time * 1e3,
                                   t.gen_time * 1e3 / max(t.gen_tokens, 1))
            else:
                launch.follow(eng, world)
        torch.cuda.synchronize()
        out["counts"][form] = dict(_build.launches)
        out["dequant"][form] = dq["n"]
        del eng, model
        torch.cuda.empty_cache()
    out["archs"] = _tp_archs(rank, world, devs)
    # a world-1 NCCL group: NCCL's collectives on CUDA tensors
    g = dist.new_group([0], backend="nccl")
    if rank == 0:
        x = torch.arange(8, dtype=torch.float32, device=DEV)
        dist.all_reduce(x, group=g)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x, group=g)
        dist.broadcast(x, 0, group=g)
        torch.cuda.synchronize()
        out["nccl"] = bool(torch.equal(parts[0], x)
                           and torch.equal(x.cpu(), torch.arange(8.0)))
    peer = comm.broadcast_bytes(
        json.dumps({k: out[k] for k in ("counts", "dequant", "archs")}
                   ).encode()
        if rank == 1 else b"", world, 1)
    if rank == 0:
        out["peer"] = json.loads(peer)
    dist.destroy_process_group()
    return out


def _parallel_follower(argv: list[str]) -> int:
    """`python chip_smoke.py --parallel-rank 1 --init tcp://...`: rank 1 of
    phase_parallel (started by it)."""
    init = argv[argv.index("--init") + 1]
    prompt = json.loads(argv[argv.index("--prompt") + 1])
    _build.build_all()  # rank 0 built them: loads the libraries
    _parallel_forms(1, init, prompt)
    return 0


def phase_parallel(card: str) -> dict:
    """Two ranks on this one card, over gloo with the CUDA tensors staged
    through the host where gloo needs it (parallel/comm.py): the
    TinyLlama-1.1B Q4_K_M model at full width and depth, a 300-token
    prompt and 32 greedy tokens under tensor parallelism (tp=2: K1, K2,
    K3, K4 and K5 on each rank's shard shapes, wk and wv kept whole on
    both ranks and checked to be the only such weights), then pipeline
    (pp=2) and sequence parallelism (sp=2), each reply checked against the
    unsharded engine's on the card (near-ties apart); no shard of the tp
    run takes the dequant path. Then tp=2 over the other model modules
    (`_tp_archs`: DeepSeek-V2-Lite widths with the experts over tp,
    RWKV6 Finch 1.6B, nomic-embed-text-v1.5 and six tiny llama-branch
    fixtures), each against the unsharded engine on the card. Then one
    all_reduce / all_gather / broadcast on CUDA tensors in a world-1 NCCL
    group. Returns both ranks' launch counts summed over the forms and
    models."""
    import subprocess

    from koboldcpp_tpu_torch.parallel import comm

    rng = np.random.default_rng(1)
    prompt = [1] + rng.integers(3, 32000, size=299).tolist()
    init = f"tcp://127.0.0.1:{comm.free_port()}"
    peer = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank", "1",
         "--init", init, "--prompt", json.dumps(prompt)], cwd=ROOT)
    try:
        gp = GenParams(max_length=PAR_TOKENS, bypass_eos=True,
                       sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
        single = Engine(synthetic_q4_k_m_on_device(TINYLLAMA_1_1B, seed=0,
                                                   device=DEV),
                        max_context=2048, device=DEV)
        want = single.generate(prompt, gp).tokens
        t = single.last_timings
        single_ms = t.gen_time * 1e3 / max(t.gen_tokens, 1)
        out = _parallel_forms(0, init, prompt)
        _check(peer.wait(timeout=300) == 0, "parallel rank 1 failed")
    finally:
        if peer.poll() is None:
            peer.kill()
    counts: dict = {}
    for side in (out, out["peer"]):
        for form in PAR_FORMS:
            for k, n in side["counts"][form].items():
                counts[k] = counts.get(k, 0) + n
        for label, a in side["archs"].items():
            for k, n in a["counts"].items():
                counts[k] = counts.get(k, 0) + n
    for rank, side in ((0, out), (1, out["peer"])):
        for label, a in side["archs"].items():
            for k in a["kernels"]:
                _check(a["counts"].get(k, 0) > 0,
                       f"{k} did not run on rank {rank}'s tp=2 {label}")
            _check(not a["rule_dequant"],
                   f"rank {rank}'s tp=2 {label} dequantized weights that "
                   f"meet the kernels' rule: {a['rule_dequant']}")
    for rank, side in ((0, out), (1, out["peer"])):
        for k in PAR_KERNELS:
            _check(side["counts"]["tp"].get(k, 0) > 0,
                   f"{k} did not run on rank {rank}'s tp=2 shard")
        _check(side["dequant"]["tp"] == 0,
               f"rank {rank}'s tp=2 run took the dequant path "
               f"{side['dequant']['tp']} times")
    for form in PAR_FORMS:
        got = out["tokens"][form]
        _check(len(got) == PAR_TOKENS, f"{form}: {len(got)} tokens")
        _same_or_near_tie(single, prompt, got, want,
                          f"{form}=2 reply")
    _check(out["nccl"], "world-1 NCCL all_reduce / all_gather / broadcast")
    del single
    torch.cuda.empty_cache()
    print(f"parallel (synthetic TinyLlama-1.1B Q4_K_M, 2 ranks on one {card}, "
          "gloo with CUDA tensors staged through the host; not NCCL and not "
          "multi-GPU figures): decode ms/token unsharded "
          f"{single_ms:.3f}, " + ", ".join(
              f"{f}=2 {out['ms'][f][1]:.3f} (prefill {out['ms'][f][0]:.1f} "
              "ms)" for f in PAR_FORMS)
          + f"; launches rank 0 tp {out['counts']['tp']}, rank 1 tp "
          f"{out['peer']['counts']['tp']}; kept whole on both tp ranks, "
          "every layer: " + ", ".join(f"{k} ({v})" for k, v in
                                      PAR_KEPT_WHOLE.items()), flush=True)
    for label, a in out["archs"].items():
        peer_counts = out["peer"]["archs"][label]["counts"]
        print(f"tp=2 {label} ({card}, 2 ranks on one card, gloo"
              + (f"; {TP_DS2_LAYERS} of 27 layers"
                 if label == "DeepSeek-V2-Lite" else
                 f"; {TP_RWKV6_LAYERS} of 24 layers"
                 if label.startswith("RWKV6") else "")
              + f"): weights built in {a['build_s']:.1f} s; "
              f"{a['check']}; request unsharded {a['single_ms']:.1f} ms, "
              f"tp=2 {a['tp_ms']:.1f} ms; kept whole on both ranks "
              f"{a['kept'] or 'none'}; launches rank 0 {a['counts']}, "
              f"rank 1 {peer_counts}", flush=True)
    print("NCCL: a world-1 group's all_reduce / all_gather / broadcast ran on "
          "CUDA tensors; NCCL across cards stays unverified until a "
          "multi-chip cell exists", flush=True)
    return counts


def _timed(phase, *args):
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[{phase.__name__}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


def main() -> int:
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {_build.build_seconds:.1f} s, all sources at once ("
          + ", ".join(f"{s} {t:.1f} s" for s, t in
                      _build.source_seconds.items()) + ")", flush=True)
    card = card_info()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    rng = np.random.default_rng(0)
    for phase in (phase_matvec, phase_windows, phase_batched_matvec,
                  phase_sbq, phase_ffn_fused, phase_kq_matmul,
                  phase_mla_shapes, phase_iq_kernels, phase_flash_prefill,
                  phase_flash_decode, phase_paged_flash_decode,
                  phase_quant_decode, phase_stacked):
        _timed(phase, rng)
    print_kq_classes()
    print_q4k_classes()
    print_dev_sums()
    print_attention_sums()
    torch.cuda.synchronize()
    global _flush
    _flush = None
    torch.cuda.empty_cache()

    # the main paths, each with the launch counts zeroed before it
    single, bf16_tps = _timed(phase_end_to_end, card)
    runs = [single, _timed(phase_quant_single, card, bf16_tps),
            _timed(phase_phi3_decode, card),
            _timed(phase_gemma2_decode, card),
            _timed(phase_phi2_decode, card),
            _timed(phase_batched_serving, card)]
    model = synthetic_model(TINYLLAMA_1_1B, "q4_k", seed=0, device=DEV)
    runs += [_timed(phase_fused_single, card, model, bf16_tps),
             _timed(phase_opt_in_batched, card, model),
             _timed(phase_opt_in_layouts, card, model),
             _timed(phase_scan_decode, card, model),
             _timed(phase_kernel_vars, card, model)]
    del model
    torch.cuda.empty_cache()
    # parallel serving (two ranks on this card: tp, pp, sp)
    runs.append(_timed(phase_parallel, card))
    runs += [_timed(phase_served_fixture), _timed(phase_new_kinds, card),
             _timed(phase_served_kinds), _timed(phase_served_opt_in),
             _timed(phase_served_archs)]
    _timed(check_fixture_goldens)
    _timed(check_opt_in_logits)
    runs.append(_timed(phase_served_features, card))
    # the vision and speech inputs (LLaVA-1.5-7B, whisper-small widths)
    runs.append(_timed(phase_llava, card))
    _timed(phase_whisper, card)
    # Stable Diffusion (SD 1.5 and SDXL widths) and the tools
    _timed(phase_sd, card)
    _timed(phase_sdxl, card)
    runs.append(_timed(phase_tools, card))
    # the MoE models (Mixtral widths 22.5 GB, DeepSeek-V2-Lite ~30 GB:
    # both fit the card) last of the timed phases, kept for their profiled
    # windows
    moe_counts, moe = _timed(phase_moe_decode, card)
    runs.append(moe_counts)
    mla_counts, mla, mla_ms = _timed(phase_deepseek2_decode, card)
    runs.append(mla_counts)
    # the recurrent, embedding and encoder-decoder models at full width
    runs.append(_timed(phase_served_text))
    text_models = {}
    for name, md, kernels in TEXT_MODELS:
        phase = (phase_embed if md["general.architecture"] == "nomic-bert"
                 else phase_text_decode)
        c, text_models[name] = _timed(phase, card, name, md, kernels)
        runs.append(c)
    # the profiled windows last: a profiler session slows later decodes
    _timed(phase_profiled, card, moe, mla, mla_ms)
    del moe, mla
    _timed(phase_text_profiled, card, text_models)
    del text_models

    kernels = []
    for kid, (name, source, replaces) in KERNELS.items():
        cases = CASES[kid]
        libs = [c["library_ms"] for c in cases]
        kernels.append({
            "name": f"{kid} {name}", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r.get(kid, 0) for r in runs),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            # times summed over the phase's cases, one call of each
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": ("operations" if any(c["bound_by"] == "operations"
                                             for c in cases) else "bytes"),
            "library_ms": None if None in libs else sum(libs)})
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--parallel-rank" in sys.argv:
        sys.exit(_parallel_follower(sys.argv))
    sys.exit(main())
