#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py            # from the root of a checkout

1. Prints the card's name and power limit (nvidia-smi), whether triton
   imports, and builds the CUDA kernels of
   ``eddie_wang_hackathon2023_tpu_torch/csrc``, the example's
   ``examples/custom_kernel_torch/fmha.cu`` and the megakernel probes'
   ``tools/megakernel_probes.cu`` with nvcc (one process per source, in
   parallel).
2. Holds every kernel of the main path against its plain PyTorch version
   on the card, at the shapes the main path gives it (the beam entry also
   at the gen_beam path's; the megakernel also with int4 panels, in
   groups of 128 and per channel, and with bf16 panels at Whisper
   large-v2's widths, at LLaMA-1B's and, in its grouped mode,
   SantaCoder-1B's widths; the int4 matmul also at Whisper large-v2's
   linears at M 1, 3 and 1536; kernel 1 also at head dim 128,
   LLaMA-1B's and ChatGLM-6B's decode), and times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``, used nowhere in the port), the
   megakernel and kernel 1's self call also over an int8 self cache; the
   probes' four kernels at their scripts' shapes (128 int8 panels, 210 MB)
   in every mode, their ``library_ms`` the loop of PyTorch calls over the
   panels that the JAX scripts measured as the XLA baseline.  The GEMV and
   the int4 matmul are also timed against ``torch._weight_int8pack_mm``
   and ``torch._weight_int4pack_mm``, one call on the quantised weight
   itself, where the card's torch has a CUDA kernel for it.  Kernel 2's
   causal mode and the user FMHA's fp32 entry are held at their edges
   (tile edges, Lq < Lk, ``valid`` < Lk, B * H past the SMs; Lq 1 and 17,
   views on 4-byte rows), each case with its plan, its time and SDPA's.
   The paged kernel's window entry (mixed admission) is held at the serve
   path's shape with prompt chunks at offsets 0, 16, 37 and 45 beside
   decode windows, over a bf16 pool, an int8 pool and one KV head.  The
   fp8 (e4m3) modes of kernel 1 (the fp8_scanned self call, bit-equal to
   its step-by-step version, and its beam entry), the grouped kernel, the
   paged kernel's three entries and both megakernel sets are held the
   same way, each over an e4m3 cache whose unused columns hold the NaN
   byte 0x7F, the megakernel's e4m3 step in turns with the others.
3. Drives the main path: Whisper large-v2 at full width (32+32 layers,
   random weights from a seed) with the bench recipe
   ``woq8+ckv8+lmq8+sqenc``, greedy transcription of a seeded 30 s mel,
   40 tokens, each decode step one launch of the megakernel.  Then the
   custom path on the same model: the transcription without, then with
   the user-written FMHA of ``examples/custom_kernel_torch`` installed by
   ``set_custom_mha`` (it must take the encoder's 32 attention calls and
   the prompt prefill's 32, and the flash kernel none), then without it
   again and with a 223-token previous-text prompt, whose prefill takes the
   flash kernel's causal mode; the encoder with the user kernel is held
   against the built-in one, the hooked run's teacher-forced logits
   against the plain path, and utt/s is printed with and without the
   hook.  Then the kv8 paths on the same model: the self-KV steps
   calibrated by ``calibrate_int8_kv`` on the main pipeline (their range
   printed), the decoder rebuilt on the same weights with the int8 self
   cache (recipe ``woq8+kv8+ckv8+lmq8+sqenc``), transcribed through the
   megakernel's int8 self mode (one launch a step; utt/s, the slope, the
   step's wall, busy and idle share) and layer by layer at full depth
   (kernel 1's self calls over the int8 cache), each replayed against the
   plain scanned path; then the fp8 path: the same decoder over an e4m3
   self cache (scales ``fp8_scales_from_amax`` of the calibration's amax)
   through the megakernel's e4m3 self mode, in turns with main.  Then on the same model the detect, long and
   best_of paths: ``detect_language`` on the seeded window (the
   probabilities summing to 1, the top 3, the step's time);
   ``transcribe_long`` with the language detected in each window over 75 s
   of seeded audio (a tone and noise), without timestamps and EOT
   suppressed, so exactly 3 windows of 30, 30 and 15 s, each 40 tokens
   through the megakernel (windows, audio seconds per wall second, ms per
   window, the launches of kernel 2 and the megakernel); one window
   sampled with ``temperature=1.0`` and ``best_of=5`` (five rows layer by
   layer through kernel 1 at batch 5, two runs of one seed equal, the first
   steps replayed against the plain path, utt/s best of 3).  Then the
   woq4 and float paths on the same encoder and cross-KV: the decoder
   made anew from the main path's seeded float state for
   ``woq4+ckv8+lmq8+sqenc`` (int4 weights, groups of 128: each decode step
   one launch of the megakernel's int4 mode) and for ``ckv8+lmq8+sqenc``
   (a float decoder: its bf16 mode), each checked, replayed and timed as
   the main path, beside the main path's numbers with the share of its
   tokens equal to the main path's.  Then the layer-by-layer (scanned)
   path,
   ``decode_megakernel=False``, at the same widths with the depth cut to
   8+8 layers and the recipe without ``sqenc`` (its encoder takes the
   bf16 flash entry), and the woq4_scanned path at the same depth with
   ``woq4+ckv8+lmq8`` (an int4 encoder: each of its linears one launch of
   the int4 kernel at M 1536; the decoder's linears one launch each a
   step), and the fp8_scanned path: the scanned path's model over an e4m3
   self cache (kernel 1's e4m3 self calls).  Then the beam
   path: beam search with 5 beams at full width, the depth cut to 8+8
   layers as the scanned path's, recipe
   ``woq8+ckv8+lmq8``, each decode step through the beam entry of the
   decode kernel (self-attention through the cache-indirection table) and
   kernel 1 at batch 5 (cross-attention).  For each path the launch
   counters are zeroed just before it and read just after: every kernel
   of the path must have run.  The decoder calls of one transcription
   (tokens, and with beams the indirection tables that encode the chosen
   parents) are replayed through the kernel path and through the plain
   scanned path (teacher forcing), and their logits must agree.  Prints
   utt/s, the decode slope (not for beams), the decoder step's wall and
   device-busy time and peak memory.  Last the decoder path: SantaCoder-1B
   (24 layers, d 2048, 16 query heads of 128 over one KV head, vocab
   49152) at full width and depth with random weights, recipe ``woq8``,
   greedy generation of 20 tokens for 8 prompts of 60 tokens (bucketed to
   64, left-padded) through the port's ``GenerationSession``, as the JAX
   package's ``benchmarks/benchmark.py -m santacoder_1b --quant woq8`` runs
   it; each decode step runs the grouped decode kernel once per layer.
   Prints tokens/s, the decode step's wall and device-busy time and peak
   memory.  Then, on the same model and prompts, a sampled call: rows 0-1
   greedy, the others at temperature 0.8 with their own top-k and top-p,
   repetition and presence penalties and min_length, bad words and stop
   words taken from earlier calls of the seed (none in the greedy rows'
   output); its greedy rows must equal the greedy call's, a second call of
   the seed its tokens, no bad word may end a row's output and a row
   must finish after its first stop word; its replay is checked as the
   greedy call's and its tokens/s printed beside them.  Then the same
   decoder path with int4 weight-only weights
   (``--quant woq4``: groups of 128 rows, the same seeded float weights
   quantised again), each linear through the int4 dequant matmul kernel
   (four a layer in the prefill and in each step); its numbers are printed
   beside the woq8 path's of the same run.  Then woq8 with an int8 KV
   cache, cut to 8 layers of the same weights, each layer's step the woq8
   run's cache amax after its prefill / 127: the grouped kernel reads the
   int8 cache, and the same with an e4m3 cache (decoder_fp8: the grouped
   kernel's e4m3 mode).  Then the santacoder paths: the same float state as
   SantaCoder-1B in bf16 and quantised woq8, at batch 1 (60 + 20 tokens),
   each decode step one launch of the megakernel's grouped (MQA) mode,
   each beside the same session layer by layer (tokens, teacher-forced
   logits within 5e-2, whole calls in turns).  Then the llama paths:
   LLaMA-1B (16 layers, weights made on the card) at batch 1 through the
   megakernel's decoder-only set (bf16 and int8 panels, and bf16 over an
   e4m3 cache: llama_fp8) and at batch 8 layer by layer (kernel 1 at head
   dim 128).  Then the bloom path:
   bloom-560m's widths (24 layers, d 1024, 16 heads of 64, vocab 250880,
   ALiBi, the embedding norm), batch 8, 60 + 20 tokens, bf16, layer by
   layer: its attention is plain PyTorch with the ALiBi bias (as the JAX
   package runs it through XLA), so no kernel may launch; its logits are
   held against its weights in fp32.  Then the chatglm path: ChatGLM-6B's
   widths (28 layers, d 4096, 32 heads of 128, 6.7 B parameters made on
   the card in the JAX layout and loaded through ``from_jax_state``),
   batch 8 with prompts of 60 down to 32 true tokens, 20 new: the
   bidirectional prompt, GLM positions, the deepnorm residual, each decode
   step kernel 1 once a layer.  Last the serve path: GPT-350M
   (24 layers, d 1024, 16 heads of 64, vocab 51200, 128 positions, bf16,
   float weights) behind the port's ``ContinuousBatchingManager`` with 8
   slots over a block-paged KV pool of 32-token blocks, 64 requests of 60
   prompt tokens and 20 new tokens each,
   greedy, as the JAX package's ``benchmarks/serve_bench.py --paged`` runs
   it; each decode tick runs the paged decode kernel once per layer.  Its
   teacher-forced check replays the recorded prefills and first ticks on a
   fresh pool.  Prints serve_bench's metrics (best of 3 runs), the tick's
   wall and device-busy time and peak memory.  Then the serve_modes path:
   the same model and requests (built once more) through five cells of
   ``serve_bench.py``, each a warm-up drain and one timed drain: the dense
   slot cache greedy (each decode step kernel 1 once a layer, each
   admission prefill kernel 2's causal mode once a layer) and at top-p 0.9
   and temperature 0.8 (as ``serve_bench.py`` builds it), the paged pool
   at that top-p, mixed admission over the pool (chunks of 16 through the
   paged kernel's window entry, once a layer a mixed tick) and
   ``steps_per_tick=4``, beams, an int8 pool and an e4m3 pool (single,
   mixed and beam cells; beams over an e4m3 slot cache); each serves every request, uses the native
   scheduler, replays its opening calls and 8 steps teacher-forced
   against the plain versions, prints its share of tokens equal to the
   serve path's (greedy) or holds two drains of one seed equal (sampled),
   and prints serve_bench's metrics.  Then the gen_beam path:
   GPT-350M at ``benchmarks/beam_bench.py``'s defaults (24 layers, d 1024,
   16 heads of 64, vocab 50257, 2048 positions, bf16, float weights),
   beam 4 through the port's ``GenerationSession`` for one prompt of 1912
   tokens (bucket 2048), 8 and 40 new tokens timed once each after a
   warm-up, as ``beam_bench.py`` times them; each decode step runs the
   beam entry of the decode kernel once per layer, reading the cache of
   2088 columns through the indirection table.  Its every recorded step
   is replayed against the plain path; prints the marginal ms a token,
   the step's wall and device-busy time and peak memory, and the share of
   the (row, column) pairs that the last step's table points at.  Then
   ``beam_bench.py``'s other mode, the whole cache gathered by parent
   every step (``use_cache_indirection=False``), kernel 1 serving each
   step: its marginal ms a token beside the indirection run's, its
   launches, and its tokens and beam scores beside the indirection
   run's.  Then greedy at batch 1 on the same prompt (``beam_bench.py
   --beam 1``): each decode step one launch of the megakernel over the
   2088 columns (9 attention slices), its tokens beside the
   layer-by-layer session's and its calls replayed teacher-forced
   through the layer-by-layer step (within 5e-2).
   Last the probes path: ``tools/megakernel_probe.py``,
   ``megakernel_probe2.py`` and ``megakernel_probe3.py`` (the counterparts
   of the JAX package's ``benchmarks/megakernel_probe{,2,3}.py``: seeded
   210 MB int8 blobs, every variant timed and held against its
   reference), each through its ``main(["--device", "cuda"])`` in this
   process; each of the four probe kernels must have launched there.
4. Runs ``examples/custom_kernel_torch/run.py --device cuda`` in this
   process, which must end with its OK line.
5. Prints one JSON line with every kernel's numbers, the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero.

Needs one CUDA card; exits non-zero with no result without one, or when
run outside a checkout of the repository.  ``--kernels-only`` stops after
step 2.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "eddie_wang_hackathon2023_tpu_torch"
SEED = 0
SAMPLE_LEN = 40
TOK_EOT = 50257

# H100 SXM peaks (NVIDIA data sheet), used for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR = 989e12
PEAK_TF32_TENSOR = 495e12
PEAK_FP32_CUDA_CORES = 67e12

KERNELS = {
    "decode_attention_int8": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:45"),
    "decode_attention_bf16": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:45"),
    "out_proj_gemv": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:62"),
    "flash_attention": dict(
        route="cuda", source=f"{PKG}/csrc/flash_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/flash_attention.py:89"),
    "flash_attention_f32": dict(
        route="cuda", source=f"{PKG}/csrc/flash_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/flash_attention.py:89"),
    "decoder_megakernel": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    # the megakernel's int8 self-KV mode (kv8) and kernel 1's self call
    # over an int8 cache, their own rows: each is its own instantiation
    "decoder_megakernel_int8_self": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    "decode_attention_int8_self": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:45"),
    # Whisper's int4 panels (woq4: groups of 128; the row also holds the
    # per-channel mode's numbers from the kernel phase, which no path
    # reaches, the group size having no knob) and bf16 panels (a float
    # decoder), each its own library of decoder_layer.cu
    "decoder_megakernel_int4": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    "decoder_megakernel_bf16": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    # the megakernel's decoder-only modes at LLaMA-1B's widths (16 layers,
    # RMSNorm, the gated SiLU MLP, RoPE, heads of 128): bf16 panels, and
    # int8 weight-only panels (woq8)
    "decoder_megakernel_llama": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    "decoder_megakernel_llama_woq8": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    # kernel 1 at head dim 128: LLaMA-1B at batch 8, layer by layer
    "decode_attention_d128": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:45"),
    # the megakernel's grouped (MQA) mode at SantaCoder-1B's widths (24
    # layers, 16 query heads of 128 over one KV head): bf16 panels, and
    # int8 weight-only panels (woq8)
    "decoder_megakernel_mqa": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    "decoder_megakernel_mqa_woq8": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    # kernel 1 at ChatGLM-6B's decode: 32 heads of 128, batch 8, each row
    # from its own start
    "decode_attention_glm": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:45"),
    "beam_decode_attention": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:213"),
    # the beam entry at the gen_beam path's shape (GPT-350M, beam 4, a
    # cache of 2088 columns from 136 on), its own row
    "beam_decode_attention_gen": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:213"),
    # kernel 1's cross-attention call at batch 5 on the beam path, its own
    # row: it reads the repeated int8 cross cache, 5 rows of 1500
    "decode_attention_int8_b5": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:45"),
    "gqa_decode_attention": dict(
        route="cuda", source=f"{PKG}/csrc/gqa_decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:410"),
    "paged_decode_attention": dict(
        route="cuda", source=f"{PKG}/csrc/paged_decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:612"),
    # the paged kernel's window entry (mixed admission): the JAX package
    # computes the window in XLA
    "paged_window_attention": dict(
        route="cuda", source=f"{PKG}/csrc/paged_decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/paged_attention.py:95"),
    # the paged kernel's beam entry (beams over the pool): the JAX package
    # reads paged beams in XLA, its masked cross-beam formulation
    "paged_beam_attention": dict(
        route="cuda", source=f"{PKG}/csrc/paged_decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/paged_attention.py:139"),
    # the beam entry of kernel 1 at the dense_beam serving cell's shape
    # (GPT-350M, 8 slots of 4 beams, a slot cache of 128 columns), its own
    # row
    "beam_decode_attention_serve": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:213"),
    # the fp8 (e4m3) cache's modes, each its own instantiation: the
    # megakernel's e4m3 self cache (Whisper's set, and the decoder-only set
    # at LLaMA-1B's widths, each a library of its own), kernel 1's self
    # call and its beam entry, the grouped kernel and the paged kernel's
    # three entries
    "decoder_megakernel_e4m3_self": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    "decoder_megakernel_llama_e4m3": dict(
        route="cuda", source=f"{PKG}/csrc/decoder_layer.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decoder_layer.py:306"),
    "decode_attention_e4m3_self": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:45"),
    "beam_decode_attention_e4m3": dict(
        route="cuda", source=f"{PKG}/csrc/decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:213"),
    "gqa_decode_attention_e4m3": dict(
        route="cuda", source=f"{PKG}/csrc/gqa_decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:410"),
    "paged_decode_attention_e4m3": dict(
        route="cuda", source=f"{PKG}/csrc/paged_decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_decode_attention.py:612"),
    "paged_window_attention_e4m3": dict(
        route="cuda", source=f"{PKG}/csrc/paged_decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/paged_attention.py:95"),
    "paged_beam_attention_e4m3": dict(
        route="cuda", source=f"{PKG}/csrc/paged_decode_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/paged_attention.py:139"),
    "int4_quant_matmul": dict(
        route="cuda", source=f"{PKG}/csrc/int4_quant_matmul.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_quant_matmul.py:25"),
    # the int4 kernel at Whisper large-v2's linears (woq4_scanned: the
    # int4 encoder at M 1536, the prompt prefill at M 3, each decode step's
    # linears at M 1)
    "int4_quant_matmul_whisper": dict(
        route="cuda", source=f"{PKG}/csrc/int4_quant_matmul.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/"
                 "pallas_quant_matmul.py:25"),
    # kernel 2's causal mode (bf16): the prompted prefill of the custom path
    "flash_attention_causal": dict(
        route="cuda", source=f"{PKG}/csrc/flash_attention.cu",
        replaces="eddie_wang_hackathon2023_tpu/ops/flash_attention.py:89"),
    # the user kernel of examples/custom_kernel_torch, installed by
    # set_custom_mha: bf16 (the prompt prefill) and fp32 (the SmoothQuant
    # encoder) entries
    "custom_fmha": dict(
        route="cuda", source="examples/custom_kernel_torch/fmha.cu",
        replaces="examples/custom_kernel/pallas_fmha.py:23"),
    "custom_fmha_f32": dict(
        route="cuda", source="examples/custom_kernel_torch/fmha.cu",
        replaces="examples/custom_kernel/pallas_fmha.py:23"),
    # the megakernel design probes of benchmarks/ (tools/megakernel_probes.py)
    "probe_flat_gemv": dict(
        route="cuda", source="tools/megakernel_probes.cu",
        replaces="benchmarks/megakernel_probe.py:61"),
    "probe_hm_gemv": dict(
        route="cuda", source="tools/megakernel_probes.cu",
        replaces="benchmarks/megakernel_probe.py:85"),
    "probe_relayout": dict(
        route="cuda", source="tools/megakernel_probes.cu",
        replaces="benchmarks/megakernel_probe2.py:48"),
    "probe_pair_proj": dict(
        route="cuda", source="tools/megakernel_probes.cu",
        replaces="benchmarks/megakernel_probe3.py:48"),
}
# the path that drives each kernel: the main path (the bench recipe, the
# megakernel decode), the layer-by-layer path (decode_megakernel=False,
# the recipe without sqenc, so the encoder takes the bf16 flash entry), the
# beam path (beam 5, the recipe without sqenc), the decoder-only, serve and
# gen_beam paths, the custom path (the main path's model with the user kernel
# installed, then without it and with a previous-text prompt), the kv8
# paths (the main path's model with an int8 self cache, through the
# megakernel and layer by layer), the llama paths (LLaMA-1B at batch 1
# through the megakernel, bf16 and woq8, and at batch 8 layer by layer), the
# santacoder paths (SantaCoder-1B at batch 1 through the megakernel's
# grouped mode, bf16 and woq8), the chatglm path (ChatGLM-6B at batch 8,
# kernel 1 in every decode step), the serve_modes path's mixed cell
# (serve_paged_mixed: mixed admission over the pool), its beam cells
# (serve_paged_beam: beams over the pool; serve_dense_beam: beams over the
# dense slot cache) or the probes path
# (the three tools/megakernel_probe*.py scripts); the fp8 paths drive the
# e4m3 rows: fp8 (the main path's model over an e4m3 self cache through
# the megakernel), fp8_scanned (the scanned path's model layer by layer),
# decoder_fp8, llama_fp8 and the serve_modes cells paged_fp8,
# paged_fp8_mixed, paged_fp8_beam and dense_fp8_beam; the bloom path runs
# no TPU kernel and so drives no row
PATH_OF = {"decoder_megakernel": "main", "flash_attention_f32": "main",
           "decoder_megakernel_llama": "llama",
           "decoder_megakernel_llama_woq8": "llama_woq8",
           "decode_attention_d128": "llama_b8",
           "decoder_megakernel_mqa": "santacoder",
           "decoder_megakernel_mqa_woq8": "santacoder_woq8",
           "decode_attention_glm": "chatglm",
           "decoder_megakernel_int8_self": "kv8",
           "decoder_megakernel_int4": "woq4",
           "decoder_megakernel_bf16": "float",
           "int4_quant_matmul_whisper": "woq4_scanned",
           "decode_attention_int8_self": "kv8_scanned",
           "decode_attention_int8": "scanned",
           "decode_attention_bf16": "scanned", "out_proj_gemv": "scanned",
           "flash_attention": "scanned", "beam_decode_attention": "beam",
           "beam_decode_attention_gen": "gen_beam",
           "decode_attention_int8_b5": "beam",
           "gqa_decode_attention": "decoder",
           "paged_decode_attention": "serve",
           "paged_window_attention": "serve_paged_mixed",
           "paged_beam_attention": "serve_paged_beam",
           "beam_decode_attention_serve": "serve_dense_beam",
           "int4_quant_matmul": "decoder_woq4",
           "flash_attention_causal": "custom", "custom_fmha": "custom",
           "custom_fmha_f32": "custom", "probe_flat_gemv": "probes",
           "probe_hm_gemv": "probes", "probe_relayout": "probes",
           "probe_pair_proj": "probes",
           "decoder_megakernel_e4m3_self": "fp8",
           "decoder_megakernel_llama_e4m3": "llama_fp8",
           "decode_attention_e4m3_self": "fp8_scanned",
           "beam_decode_attention_e4m3": "serve_dense_fp8_beam",
           "gqa_decode_attention_e4m3": "decoder_fp8",
           "paged_decode_attention_e4m3": "serve_paged_fp8",
           "paged_window_attention_e4m3": "serve_paged_fp8_mixed",
           "paged_beam_attention_e4m3": "serve_paged_fp8_beam"}
PROBE_SCRIPTS = ("megakernel_probe", "megakernel_probe2", "megakernel_probe3")
# the launch counter of a row named otherwise
COUNTER_OF = {"decode_attention_int8_b5": "decode_attention_int8",
              "decoder_megakernel_llama": "decoder_megakernel",
              "decoder_megakernel_llama_woq8": "decoder_megakernel",
              "decode_attention_d128": "decode_attention_bf16",
              "decoder_megakernel_mqa": "decoder_megakernel",
              "decoder_megakernel_mqa_woq8": "decoder_megakernel",
              "decode_attention_glm": "decode_attention_bf16",
              "beam_decode_attention_gen": "beam_decode_attention",
              "beam_decode_attention_serve": "beam_decode_attention",
              "decoder_megakernel_int8_self": "decoder_megakernel",
              "decoder_megakernel_int4": "decoder_megakernel",
              "decoder_megakernel_bf16": "decoder_megakernel",
              "int4_quant_matmul_whisper": "int4_quant_matmul",
              "decode_attention_int8_self": "decode_attention_int8",
              "decoder_megakernel_e4m3_self": "decoder_megakernel",
              "decoder_megakernel_llama_e4m3": "decoder_megakernel",
              "decode_attention_e4m3_self": "decode_attention_e4m3"}
# the long path: windows of seeded audio (2.5: 75 s on large-v2, windows
# of 30, 30 and 15 s); the best_of path's sampled rows an utterance
LONG_WINDOWS = 2.5
BEST_OF = 5
# the main path's recipe with the int8 self-KV cache
KV8_RECIPE = "woq8+kv8+ckv8+lmq8+sqenc"
# the decoder-only path under woq8+kv8: SantaCoder-1B's widths at this depth
KV8_DEC_DEPTH = 8
SCANNED_RECIPE = "woq8+ckv8+lmq8"
SCANNED_DEPTH = 8        # encoder and decoder layers of the scanned path
# Whisper's int4 recipe (bench.py's BENCH_QUANT=woq4+...): the main path's
# with int4 weights; without sqenc (an int4 encoder) on the woq4_scanned
# path, at SCANNED_DEPTH; and a float decoder (bf16 panels at batch 1)
WOQ4_RECIPE = "woq4+ckv8+lmq8+sqenc"
WOQ4_SCANNED_RECIPE = "woq4+ckv8+lmq8"
FLOAT_RECIPE = "ckv8+lmq8+sqenc"
# Whisper large-v2's linears (K, N): the int4 kernel's shapes on the woq4
# paths
WHISPER_INT4_SHAPES = (("qkv", 1280, 3840), ("dense", 1280, 1280),
                       ("fc1", 1280, 5120), ("fc2", 5120, 1280))
BEAM_SIZE = 5
# the decoder path: benchmark.py's defaults (batch 8, 60 prompt tokens, 20
# new ones)
DEC_BATCH, DEC_PROMPT, DEC_NEW = 8, 60, 20
# the decoder path's sampled call: rows 0-1 greedy, the others sampled with
# these top-k and top-p (0: off), one seed
SAMPLED_GREEDY_ROWS, SAMPLED_SEED = 2, 17
SAMPLED_TOP_K = (1, 1, 0, 8, 40, 50, 0, 8)
SAMPLED_TOP_P = (0.0, 0.0, 0.9, 0.0, 0.95, 0.9, 0.95, 0.0)
# the gen_beam path: beam_bench.py's defaults (beam 4; 8 and 40 new tokens)
GEN_BEAM_WIDTH, GEN_BEAM_NEW = 4, (8, 40)
# the serve path: serve_bench.py's defaults (64 requests through 8 slots, 60
# prompt tokens, 20 new ones, max_seq_len 128, 32 tokens per block)
SERVE_REQUESTS, SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 64, 8, 60, 20
SERVE_MAX_SEQ, SERVE_BLOCK = 128, 32
# the custom path's previous-text prompt: the longest Whisper keeps
# (n_text_ctx // 2 - 1 tokens), as long-form transcription conditions each
# window on the text before it; its prefill adds sot_prev and the 3 tokens
# of the sot sequence (sot, language, task)
PROMPT_LEN = 223
PROMPTED_PREFILL = PROMPT_LEN + 4


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"[ok] {what}")


def bound(n_bytes, flops, peak):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_spin_cycles_per_ms = []


def event(torch):
    return torch.cuda.Event(enable_timing=True)


def spin(torch, ms):
    """Hold the stream for ``ms`` with a spin kernel (``torch.cuda._sleep``)
    so that the host can queue work behind it: CUDA events around that
    work then time the device, not the host, whose launch of a small
    kernel from Python takes longer than the kernel."""
    if not _spin_cycles_per_ms:
        # the first launch loads the spin kernel, which the events would
        # count: calibrate on the second, long enough to hide the host
        torch.cuda._sleep(1000)
        a, b = event(torch), event(torch)
        a.record()
        torch.cuda._sleep(10 ** 8)
        b.record()
        b.synchronize()
        _spin_cycles_per_ms.append(10 ** 8 / a.elapsed_time(b))
        print(f"timing spin: {_spin_cycles_per_ms[0]:.0f} cycles per ms")
    torch.cuda._sleep(int(ms * _spin_cycles_per_ms[0]))


def queued_ms(torch, fn, iters, host_ms):
    """Device time of one of ``iters`` calls of ``fn`` launched back to
    back behind a :func:`spin`, from CUDA events.  ``host_ms``, the host's
    time for the calls, sizes the spin; the spin grows until the host
    enqueues the last call before it ends.  None if it still does not
    (``fn`` waits on the device, or launches more kernels than the
    stream's launch queue holds)."""
    spin_ms = 4 * host_ms + 10
    for _ in range(3):
        start, end = event(torch), event(torch)
        spin(torch, spin_ms)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        behind = start.query()      # the spin ended before the last call
        end.synchronize()
        if not behind:
            return start.elapsed_time(end) / iters
        spin_ms *= 4
    return None


def step_device_ms(torch, dec, run_step, host_ms):
    """Device time of one decoder step ``run_step()`` without the profiler.
    A scanned step launches more kernels than the queue behind one spin
    holds, so forward hooks cut it at its blocks' boundaries into segments
    of one block each (a megakernel step, whose blocks are not called, is
    one segment); each segment is queued behind its own
    :func:`spin` and timed by its own events, and the spins fall between
    the segments.  ``host_ms``, the host's time for the step, sizes the
    spins.  None if the host still fell behind a spin after two retries."""
    n_seg = len(dec.blocks) + 1
    spin_ms = 4 * host_ms / n_seg + 1
    for _ in range(3):
        marks, behind = [], []

        def close(*_):
            start, end = marks[-1]
            end.record()
            behind.append(start.query())

        def boundary(*_):
            if marks:
                close()
            spin(torch, spin_ms)
            marks.append((event(torch), event(torch)))
            marks[-1][0].record()

        hooks = [dec.register_forward_pre_hook(boundary),
                 dec.register_forward_hook(close)]
        hooks += [b.register_forward_pre_hook(boundary) for b in dec.blocks]
        try:
            run_step()
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        if not any(behind):
            return sum(s.elapsed_time(e) for s, e in marks)
        spin_ms *= 4
    return None


def segments_ms(torch, fns, host_ms):
    """Device time of the calls ``fns`` run in order, each queued behind its
    own :func:`spin` and timed by its own events, summed: for work that
    launches more kernels than the launch queue holds.  ``host_ms``, the
    host's time for all of them, sizes the spins.  None if the host still
    fell behind a spin after two retries."""
    spin_ms = 4 * host_ms / len(fns) + 1
    for _ in range(3):
        marks, behind = [], []
        for fn in fns:
            spin(torch, spin_ms)
            marks.append((event(torch), event(torch)))
            marks[-1][0].record()
            fn()
            marks[-1][1].record()
            behind.append(marks[-1][0].query())
        torch.cuda.synchronize()
        if not any(behind):
            return sum(s.elapsed_time(e) for s, e in marks)
        spin_ms *= 4
    return None


def time_ms(torch, fn, iters=30, warmup=5):
    """(device ms, host ms) of one call of ``fn``: the device time from
    :func:`queued_ms`, and the wall time per call of a loop ending in a
    synchronise (what a caller that launches back to back sees)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / iters * 1e3
    dev_ms = queued_ms(torch, fn, iters, wall_ms * iters)
    if dev_ms is None:
        raise SmokeFailure("the host could not queue the timed calls ahead "
                           "of the device")
    return dev_ms, wall_ms


def kernel_breakdown(torch, run, n, top=8):
    """(kernel ms, {kernel name: ms}) per unit of ``run()`` (``n`` units of
    work): the device time of all its kernels and of the ``top`` largest,
    from a CUDA-only profiler trace.  (None, None) where the profiler
    records no device time (it cannot trace every machine's card)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
        kern = [e for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", "CUDA"))
                and getattr(e, "self_device_time_total", 0) > 0]
    except RuntimeError as e:
        print(f"  profiler failed: {e}")
        return None, None
    if not kern:
        return None, None
    # kernels whose names agree in the first 80 characters (instantiations
    # of one template) are summed under that prefix
    per_name = {}
    for e in kern:
        per_name[e.key[:80]] = (per_name.get(e.key[:80], 0.0)
                                + e.self_device_time_total / n / 1e3)
    largest = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(per_name.values()), dict(largest)


def replayer(model, calls, cache):
    """``call(j)``: the recorded call j of one run (forward pre-hook:
    (args, kwargs), the cache second among the args) replayed on
    ``cache``."""
    def call(j):
        args, kw = calls[j]
        return model(args[0], cache, *args[2:], **kw)
    return call


def step_timing(torch, model, call, label, first=1, n_prof=8):
    """Where a decoder step's time goes: ``call(j)`` replays recorded call
    j on a fresh cache; calls 0..first-1 (the prefills) run first, then
    calls first..first+n_prof-1 are timed as steps: their wall time, their
    device-busy time (CUDA events behind spins, a step cut at its blocks)
    and, where the profiler can trace the card, the device time of each
    kernel.  Prints them; returns a dict."""
    def steps():
        for j in range(n_prof):
            call(first + j)
        torch.cuda.synchronize()

    with torch.inference_mode():
        for j in range(first):
            call(j)
        steps()
        t = time.perf_counter()
        steps()
        step_ms = (time.perf_counter() - t) / n_prof * 1e3
        busy = [step_device_ms(torch, model, lambda j=j: call(first + j),
                               step_ms) for j in range(n_prof)]
        busy_ms = None if None in busy else sum(busy) / n_prof
        kern_ms, top = kernel_breakdown(torch, steps, n_prof)
    idle = None if busy_ms is None else 1 - busy_ms / step_ms
    print(f"[{label}] decoder step (teacher-forced): {step_ms:.3f} ms wall, "
          "device busy " + ("not measured (the host fell behind the timing "
                            "spins)" if busy_ms is None else
                            f"{busy_ms:.3f} ms, idle share {idle:.3f}"))
    if top is None:
        print("  the profiler recorded no device time: per-kernel breakdown "
              "not measured")
    else:
        print(f"  profiler: {kern_ms:.3f} ms of kernels per step")
        for name, ms in top.items():
            print(f"  {ms * 1e3:9.1f} us/step  {name}")
    return dict(decoder_step_ms=step_ms, device_busy_ms_per_step=busy_ms,
                device_idle_share=idle, kernel_ms_per_step=kern_ms,
                top_kernels_ms_per_step=top)


def prefill_timing(torch, model, call, label, n=3):
    """The prefill's wall and device-busy time: ``call(0)``, the recorded
    prefill, replayed on a fresh cache after a warm-up; wall ms on the
    host clock up to a synchronize, the best of ``n``; busy ms as
    :func:`step_device_ms` times a step (the call cut at its blocks, each
    block behind its own spin), which a prefill that waits on the device
    defeats, and the device time of its kernels from a profiler trace of
    ``n`` calls, with the largest.  Prints them; returns a dict."""
    def calls():
        for _ in range(n):
            call(0)
        torch.cuda.synchronize()

    with torch.inference_mode():
        call(0)
        torch.cuda.synchronize()
        walls = []
        for _ in range(n):
            t = time.perf_counter()
            call(0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        wall_ms = min(walls)
        busy_ms = step_device_ms(torch, model, lambda: call(0), wall_ms)
        kern_ms, top = kernel_breakdown(torch, calls, n)
    idle = None if busy_ms is None else 1 - busy_ms / wall_ms
    print(f"[{label}] prefill (teacher-forced): {wall_ms:.3f} ms wall, "
          "device busy " + ("not measured (the host fell behind the timing "
                            "spins)" if busy_ms is None else
                            f"{busy_ms:.3f} ms, idle share {idle:.3f}"))
    if top is None:
        print("  the profiler recorded no device time: the prefill's kernels "
              "not measured")
    else:
        print(f"  profiler: {kern_ms:.3f} ms of kernels per prefill "
              f"({kern_ms / wall_ms:.3f} of its wall)")
        for name, ms in top.items():
            print(f"  {ms * 1e3:9.1f} us/prefill  {name}")
    return dict(prefill_ms=wall_ms, prefill_device_busy_ms=busy_ms,
                prefill_device_idle_share=idle,
                prefill_kernel_ms=kern_ms, prefill_top_kernels_ms=top)


def packed_library_ms(torch, fn, ref):
    """(ms, rel err, note) of ``fn``, one call of a PyTorch op on packed
    quantised weights, where the card's torch has a CUDA kernel for it;
    otherwise (None, None, "no CUDA kernel in torch <version>: ...")."""
    try:
        out = fn(0)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, None, (f"no CUDA kernel in torch {torch.__version__}: "
                            f"{str(e).splitlines()[0][:160]}")
    ms, _ = time_ms(torch, fn)
    return ms, rel_err(out, ref), f"torch {torch.__version__}"


def rel_err(out, ref):
    ref = ref.float()
    return float((out.float() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-6)


# -- phase 2: kernels against their plain versions ---------------------------

def split_of(da, S):
    """Kernel 1's cluster at a cache of S columns, for its results line:
    the blocks the wrapper passes to the kernel (its cluster is (1, 1,
    splits))."""
    return dict(splits=da.decode_splits(S))


def hopper_grid_of(torch, fa, B, H, Lq):
    """Kernel 2's bf16 Hopper grid at [B, H, Lq, 64], its waves over the
    card's SMs at the blocks an SM that the occupancy query finds for the
    built kernel, and its stages, as the library reports them."""
    cfg = fa.hopper_config()
    check(cfg["blocks_per_sm"] >= 1,
          f"the Hopper flash kernel fits on an SM ({cfg})")
    grid = [-(-Lq // cfg["rows"]), B * H]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(grid=grid, waves=grid[0] * grid[1] / (
        sms * cfg["blocks_per_sm"]), stages=cfg["stages"])


def split_checks(torch, gen):
    """Kernel 1 without beams against plain_split_decode_attention (bit for
    bit) and the fp32 plain version (1e-2) at the cross shapes (20 heads of
    64, S = 1500: 6 slices of 252), int8 and bf16, batch 5 and 1: lengths
    at 256-column and slice edges, a start inside a slice, a start that
    masks a whole slice, nothing cached with the fresh column only."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    H, D, S = 20, 64, 1500
    cases = [
        ("int8, lengths 1 4 255 256 257", torch.int8, [1, 4, 255, 256, 257],
         None, False),
        ("int8, batch 1, length 1499", torch.int8, [1499], None, False),
        ("bf16, fresh, lengths 1500 252 253 700 0, start 260 in row 3",
         torch.bfloat16, [1500, 252, 253, 700, 0], [0, 0, 0, 260, 0], True),
        ("bf16, batch 1, fresh, start 300 masks slice 0", torch.bfloat16,
         [1500], [300], True),
    ]
    for what, dtype, lens, starts, fresh in cases:
        B = len(lens)
        q = torch.randn((B, H, 1, D), generator=gen, device=dev).bfloat16()
        if dtype == torch.int8:
            cache = torch.randint(-127, 128, (1, B, 2, H, D, S),
                                  generator=gen, device=dev,
                                  dtype=torch.int8)
            fkv = tuple(torch.randint(-127, 128, (B, H, D, 1), generator=gen,
                                      device=dev, dtype=torch.int8)
                        for _ in range(2))
            kw = dict(kv_quant_orig_scale=torch.tensor(1 / 40.0, device=dev))
        else:
            cache = torch.randn((1, B, 2, H, D, S), generator=gen,
                                device=dev).bfloat16()
            fkv = tuple(torch.randn((B, H, D, 1), generator=gen,
                                    device=dev).bfloat16() for _ in range(2))
            kw = {}
        if fresh:
            kw["fresh_kv"] = fkv
        if starts is not None:
            kw["start_index"] = torch.tensor(starts, device=dev)
        seq = torch.tensor(lens, dtype=torch.int32, device=dev) + int(fresh)
        out = da.fused_decode_attention(cache, 0, q, seq, D ** -0.5, **kw)
        split = da.plain_split_decode_attention(
            cache, 0, q, seq, D ** -0.5, splits=da.decode_splits(S), **kw)
        f32 = (lambda t: t) if dtype == torch.int8 else (lambda t: t.float())
        kw32 = {k: (tuple(f32(t) for t in v) if k == "fresh_kv" else v)
                for k, v in kw.items()}
        e32 = rel_err(out, da.plain_decode_attention(
            f32(cache), 0, q.float(), seq, D ** -0.5, **kw32))
        torch.cuda.synchronize()
        n_diff = int((out != split).sum())
        check(n_diff == 0 and e32 < 1e-2,
              f"decode split ({what}): {n_diff} elements differ from "
              f"plain_split_decode_attention; rel err {e32:.3e} vs fp32 "
              "plain (< 1e-2)")


def kernel_phases(torch, results):
    import torch.nn.functional as F

    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    from eddie_wang_hackathon2023_tpu_torch.ops.quant_matmul import \
        weight_only_quant_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    L, H, D, d = 32, 20, 64, 1280
    scale = D ** -0.5

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # the out-projection panel of every layer [L, H*D, N] int8 + scale + bias
    w = torch.randint(-127, 128, (L, d, d), generator=gen, device=dev,
                      dtype=torch.int8)
    w_scale = (torch.rand(d, generator=gen, device=dev) + 0.5) / (127 * 36.0)
    w_bias = randn(d) * 0.1

    # kernel 1, cross-attention: int8 cache S=1500 with per-layer scales
    S = 1500
    cross = torch.randint(-127, 128, (L, 1, 2, H, D, S), generator=gen,
                          device=dev, dtype=torch.int8)
    cscale = torch.full((L,), 1 / 40.0, device=dev)
    q = randn(1, H, 1, D)
    s_full = torch.full((1,), S, dtype=torch.int32, device=dev)

    def cross_call(layer, impl=da.fused_decode_attention):
        return impl(cross, layer, q, s_full, scale,
                    kv_quant_orig_scale=cscale[layer],
                    proj=(w[layer], w_scale, w_bias))

    out = cross_call(3)
    ref = cross_call(3, da.plain_decode_attention)
    ref32 = da.plain_decode_attention(
        cross, 3, q.float(), s_full, scale, kv_quant_orig_scale=cscale[3],
        proj=(w[3], w_scale, w_bias.float()))
    torch.cuda.synchronize()
    e16, e32 = rel_err(out, ref), rel_err(out, ref32)
    print(f"decode cross: rel err vs plain bf16 {e16:.3e}, vs fp32 "
          f"{e32:.3e}")
    check(e16 < 2e-2 and e32 < 1e-2,
          "decode attention (int8 cross, S=1500, proj) matches plain "
          "(rel 2e-2 bf16, 1e-2 fp32)")
    ctx = da.fused_decode_attention(cross, 3, q, s_full, scale,
                                    kv_quant_orig_scale=cscale[3])
    ctx_ref = da.plain_decode_attention(cross, 3, q.float(), s_full, scale,
                                        kv_quant_orig_scale=cscale[3])
    err_ctx = float((ctx.float() - ctx_ref).abs().max())
    check(rel_err(ctx, ctx_ref) < 1e-2,
          "decode attention context alone (int8 cross) matches fp32 plain")
    split_checks(torch, gen)
    # timings rotate over the 32 layers (123 MB of cache, past the 50 MB L2)
    ms, wall = time_ms(torch, lambda i: da.fused_decode_attention(
        cross, i % L, q, s_full, scale, kv_quant_orig_scale=cscale[i % L]))
    plain_ms, _ = time_ms(torch, lambda i: da.plain_decode_attention(
        cross, i % L, q, s_full, scale, kv_quant_orig_scale=cscale[i % L]))
    kd = cross.float().mul(1 / 40.0).to(torch.bfloat16)   # [L,1,2,H,D,S]
    k_sd = kd[:, :, 0].transpose(-1, -2).contiguous()      # [L,1,H,S,D]
    v_sd = kd[:, :, 1].transpose(-1, -2).contiguous()
    del kd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms, _ = time_ms(torch, lambda i: sdpa(q, k_sd[i % L], v_sd[i % L],
                                              scale=scale))
    del k_sd, v_sd
    b_ms, b_by = bound(2 * H * D * S + 2 * 2 * H * D + 4, 4 * H * D * S,
                       PEAK_FP32_CUDA_CORES)
    results["decode_attention_int8"] = dict(
        max_abs_err=err_ctx, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, host_call_ms=wall,
        **split_of(da, S))

    # kernel 1 epilogue: the out-projection GEMV, [1,1280] x [1280,1280]
    x = randn(1, d)
    g_out = da.out_proj_gemv(x, 5, w, w_scale, w_bias)
    g_ref = weight_only_quant_matmul(x.float(), w[5], w_scale) \
        + w_bias.float()
    g_err = float((g_out.float() - g_ref).abs().max())
    check(rel_err(g_out, g_ref) < 1e-2,
          "out-projection GEMV matches fp32 plain (rel 1e-2)")
    ms, wall = time_ms(torch, lambda i: da.out_proj_gemv(x, i % L, w,
                                                         w_scale, w_bias))
    plain_ms, _ = time_ms(torch, lambda i: weight_only_quant_matmul(
        x, w[i % L], w_scale) + w_bias)
    # library: one F.linear (cuBLAS) with the bias, on the weight
    # dequantised to bf16 once beforehand, [L, N, K] (twice the int8 bytes)
    w_lin = (w.float() * w_scale).to(torch.bfloat16).transpose(1, 2) \
        .contiguous()
    lib_ms, _ = time_ms(torch, lambda i: F.linear(x, w_lin[i % L], w_bias))
    del w_lin
    # the same product in one PyTorch call on the int8 weight itself, where
    # the card's torch has a CUDA kernel for it: _weight_int8pack_mm (bf16
    # x, int8 [N, K], per-channel scales; the bias not added)
    w_nk = w.transpose(1, 2).contiguous()
    s16 = w_scale.to(torch.bfloat16)
    p8_ms, p8_err, p8_note = packed_library_ms(
        torch, lambda i: torch._weight_int8pack_mm(x, w_nk[i % L], s16),
        weight_only_quant_matmul(x.float(), w[0], w_scale))
    del w_nk
    print(f"out-projection GEMV: {ms * 1e3:.2f} us; F.linear on the "
          f"dequantised weight {lib_ms * 1e3:.2f} us; _weight_int8pack_mm "
          + (f"{p8_ms * 1e3:.2f} us (rel err {p8_err:.3e})" if p8_ms
             else p8_note))
    b_ms, b_by = bound(d * d + 2 * d + 4 * d + 2 * d + 2 * d, 2 * d * d,
                       PEAK_FP32_CUDA_CORES)
    # the pair as the scanned path calls it for each attention layer: kernel
    # 1 then the GEMV (it loads its weights while kernel 1 runs), cross and
    # self; kernel 1 alone is timed below
    pair_cross, _ = time_ms(torch, lambda i: cross_call(i % L))
    print(f"kernel 1 (cross) + the GEMV: {pair_cross * 1e3:.2f} us a pair")
    results["out_proj_gemv"] = dict(
        max_abs_err=g_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, host_call_ms=wall,
        library_int8pack_ms=p8_ms, library_int8pack=p8_note,
        plan=da.gemv_plan(1, d, d, torch.cuda.get_device_properties(dev)
                          .multi_processor_count),
        pair_cross_ms=pair_cross)

    # kernel 1, self-attention: bf16 cache S=448, fresh K/V, proj
    S2 = 448
    self_cache = randn(L, 1, 2, H, D, S2)
    fresh = (randn(1, H, D, 1), randn(1, H, D, 1))
    for n in (4, 44):
        seq = torch.full((1,), n, dtype=torch.int32, device=dev)
        out = da.fused_decode_attention(self_cache, 7, q, seq, scale,
                                        fresh_kv=fresh,
                                        proj=(w[7], w_scale, w_bias))
        ref = da.plain_decode_attention(self_cache, 7, q, seq, scale,
                                        fresh_kv=fresh,
                                        proj=(w[7], w_scale, w_bias))
        ref32 = da.plain_decode_attention(
            self_cache.float(), 7, q.float(), seq, scale,
            fresh_kv=tuple(t.float() for t in fresh),
            proj=(w[7], w_scale, w_bias.float()))
        e16, e32 = rel_err(out, ref), rel_err(out, ref32)
        print(f"decode self seq {n}: rel err vs plain bf16 {e16:.3e}, "
              f"vs fp32 {e32:.3e}")
        check(e16 < 2e-2 and e32 < 1e-2,
              f"decode attention (bf16 self, S=448, seq {n}, fresh, proj)"
              " matches plain")
    # timed at the longer length (n = 44)
    ctx = da.fused_decode_attention(self_cache, 7, q, seq, scale,
                                    fresh_kv=fresh)
    ctx_ref = da.plain_decode_attention(
        self_cache.float(), 7, q.float(), seq, scale,
        fresh_kv=tuple(t.float() for t in fresh))
    err_ctx = float((ctx.float() - ctx_ref).abs().max())
    ms, wall = time_ms(torch, lambda i: da.fused_decode_attention(
        self_cache, i % L, q, seq, scale, fresh_kv=fresh))
    plain_ms, _ = time_ms(torch, lambda i: da.plain_decode_attention(
        self_cache, i % L, q, seq, scale, fresh_kv=fresh))
    k_sd, v_sd = (torch.cat(
        [self_cache[:, :, j, :, :, :n - 1],
         fresh[j][None].expand(L, -1, -1, -1, -1)],
        dim=-1).transpose(-1, -2).contiguous() for j in (0, 1))
    lib_ms, _ = time_ms(torch, lambda i: sdpa(q, k_sd[i % L], v_sd[i % L],
                                              scale=scale))
    b_ms, b_by = bound(2 * H * D * n * 2 + 2 * 2 * H * D,
                       4 * H * D * n, PEAK_FP32_CUDA_CORES)
    results["decode_attention_bf16"] = dict(
        max_abs_err=err_ctx, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, host_call_ms=wall,
        **split_of(da, S2))
    pair_self, _ = time_ms(torch, lambda i: da.fused_decode_attention(
        self_cache, i % L, q, seq, scale, fresh_kv=fresh,
        proj=(w[i % L], w_scale, w_bias)))
    print(f"kernel 1 (self) + the GEMV: {pair_self * 1e3:.2f} us a pair")
    results["out_proj_gemv"]["pair_self_ms"] = pair_self

    # kernel 1, self-attention over an int8 cache (kv8): S=448, the fresh
    # K/V in int8, the per-tensor dequantise step
    self8 = torch.randint(-127, 128, (L, 1, 2, H, D, S2), generator=gen,
                          device=dev, dtype=torch.int8)
    fresh8 = tuple(torch.randint(-127, 128, (1, H, D, 1), generator=gen,
                                 device=dev, dtype=torch.int8)
                   for _ in range(2))
    kqo = torch.full((1,), 1 / 40.0, device=dev)
    for n in (4, 44):
        seq = torch.full((1,), n, dtype=torch.int32, device=dev)
        kw = dict(kv_quant_orig_scale=kqo, fresh_kv=fresh8)
        out = da.fused_decode_attention(self8, 7, q, seq, scale, **kw,
                                        proj=(w[7], w_scale, w_bias))
        ref = da.plain_decode_attention(self8, 7, q, seq, scale, **kw,
                                        proj=(w[7], w_scale, w_bias))
        ref32 = da.plain_decode_attention(self8, 7, q.float(), seq, scale,
                                          **kw, proj=(w[7], w_scale,
                                                      w_bias.float()))
        e16, e32 = rel_err(out, ref), rel_err(out, ref32)
        print(f"decode self int8 seq {n}: rel err vs plain bf16 {e16:.3e}, "
              f"vs fp32 {e32:.3e}")
        check(e16 < 2e-2 and e32 < 1e-2,
              f"decode attention (int8 self, S=448, seq {n}, fresh, proj)"
              " matches plain")
    ctx = da.fused_decode_attention(self8, 7, q, seq, scale, **kw)
    ctx_ref = da.plain_decode_attention(self8, 7, q.float(), seq, scale,
                                        **kw)
    err_ctx = float((ctx.float() - ctx_ref).abs().max())
    ms, wall = time_ms(torch, lambda i: da.fused_decode_attention(
        self8, i % L, q, seq, scale, **kw))
    # the plain version's dequantising calls: 10 of them fit the launch
    # queue behind one spin
    plain_ms, _ = time_ms(torch, lambda i: da.plain_decode_attention(
        self8, i % L, q, seq, scale, **kw), iters=10)
    # library: SDPA on the valid columns and the fresh one, dequantised to
    # bf16 and transposed beforehand
    k_sd, v_sd = (torch.cat(
        [self8[:, :, j, :, :, :n - 1],
         fresh8[j][None].expand(L, -1, -1, -1, -1)],
        dim=-1).float().mul(1 / 40.0).to(torch.bfloat16).transpose(-1, -2)
        .contiguous() for j in (0, 1))
    lib_ms, _ = time_ms(torch, lambda i: sdpa(q, k_sd[i % L], v_sd[i % L],
                                              scale=scale))
    del k_sd, v_sd
    b_ms, b_by = bound(2 * H * D * n + 2 * 2 * H * D + 4, 4 * H * D * n,
                       PEAK_FP32_CUDA_CORES)
    pair_self8, _ = time_ms(torch, lambda i: da.fused_decode_attention(
        self8, i % L, q, seq, scale, **kw, proj=(w[i % L], w_scale, w_bias)))
    print(f"kernel 1 (int8 self): {ms * 1e3:.2f} us, + the GEMV "
          f"{pair_self8 * 1e3:.2f} us a pair; bound {b_ms * 1e3:.3f} us; "
          f"plain {plain_ms * 1e3:.2f} us; SDPA on the dequantised K/V "
          f"{lib_ms * 1e3:.2f} us")
    results["decode_attention_int8_self"] = dict(
        max_abs_err=err_ctx, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, host_call_ms=wall,
        pair_ms=pair_self8, **split_of(da, S2))
    del self_cache, self8, cross, w

    # kernel 2: encoder flash attention [1,20,1536,64], valid 1500, with
    # q/k/v as strided views of the fused QKV output, as the encoder has
    Lq, valid = 1536, 1500
    qkv = randn(1, Lq, 3, H, D)
    qs, ks, vs = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = fa.flash_mha(qs, ks, vs, scale=scale, kv_valid_len=valid)
    o_ref = fa.plain_flash_mha(qs, ks, vs, scale=scale, kv_valid_len=valid)
    o_ref32 = fa.plain_flash_mha(qs.float(), ks.float(), vs.float(),
                                 scale=scale, kv_valid_len=valid)
    e16, e32 = rel_err(o, o_ref), rel_err(o, o_ref32)
    print(f"flash: rel err vs plain bf16 {e16:.3e}, vs fp32 {e32:.3e}")
    check(e16 < 2e-2 and e32 < 1e-2,
          "flash attention [1,20,1536,64] valid 1500 matches plain "
          "(rel 2e-2 bf16, 1e-2 fp32)")
    buf = torch.empty(1, Lq, H, D, dtype=torch.bfloat16, device=dev)
    fa.flash_mha(qs, ks, vs, scale=scale, kv_valid_len=valid,
                 out=buf.transpose(1, 2))
    check(torch.equal(buf.transpose(1, 2), o),
          "flash attention writes the [B,L,H,D] output view identically")
    ms, wall = time_ms(torch, lambda i: fa.flash_mha(
        qs, ks, vs, scale=scale, kv_valid_len=valid))
    plain_ms, _ = time_ms(torch, lambda i: fa.plain_flash_mha(
        qs, ks, vs, scale=scale, kv_valid_len=valid), iters=10)
    kc, vc = ks[:, :, :valid].contiguous(), vs[:, :, :valid].contiguous()
    qc = qs.contiguous()
    lib_ms, _ = time_ms(torch, lambda i: sdpa(qc, kc, vc, scale=scale))
    b_ms, b_by = bound(4 * H * Lq * D * 2, 4 * H * Lq * valid * D,
                       PEAK_BF16_TENSOR)
    results["flash_attention"] = dict(
        max_abs_err=float((o.float() - o_ref32).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        host_call_ms=wall, **hopper_grid_of(torch, fa, 1, H, Lq))
    del qkv, qs, ks, vs, kc, vc, qc
    # the Hopper entry at the edges of its 64-key tiles and 128-row blocks
    for lq_e, valid_e in ((Lq, 127), (Lq, 128), (Lq, 129), (200, valid)):
        qkv_e = randn(1, Lq, 3, H, D)
        q_e = qkv_e[:, :lq_e, 0].transpose(1, 2)
        k_e, v_e = (qkv_e[:, :, i].transpose(1, 2) for i in (1, 2))
        o_e = fa.flash_mha(q_e, k_e, v_e, scale=scale, kv_valid_len=valid_e)
        e32 = rel_err(o_e, fa.plain_flash_mha(
            q_e.float(), k_e.float(), v_e.float(), scale=scale,
            kv_valid_len=valid_e))
        check(e32 < 1e-2, f"flash attention [1,{H},{lq_e},{D}] over {Lq} "
              f"keys, valid {valid_e}: rel err {e32:.3e} vs fp32 plain "
              "(< 1e-2)")
    del qkv_e, q_e, k_e, v_e, o_e

    # kernel 2, fp32-operand entry: the SmoothQuant encoder's fp32 q/k/v
    qkv32 = torch.randn((1, Lq, 3, H, D), generator=gen, device=dev)
    q32, k32, v32 = (qkv32[:, :, i].transpose(1, 2) for i in range(3))
    o32 = fa.flash_mha(q32, k32, v32, scale=scale, kv_valid_len=valid)
    o32_ref = fa.plain_flash_mha(q32, k32, v32, scale=scale,
                                 kv_valid_len=valid)
    o16 = fa.flash_mha(*(t.bfloat16() for t in (q32, k32, v32)),
                       scale=scale, kv_valid_len=valid)
    e32, e16 = rel_err(o32, o32_ref), rel_err(o16, o32_ref)
    print(f"flash fp32 entry: rel err vs fp32 plain {e32:.3e} (the bf16 "
          f"entry on the same inputs: {e16:.3e})")
    check(o32.dtype == torch.float32 and e32 < 1e-4,
          "flash attention fp32 entry [1,20,1536,64] valid 1500 within 1e-4 "
          "of the fp32 plain version")
    ms, wall = time_ms(torch, lambda i: fa.flash_mha(
        q32, k32, v32, scale=scale, kv_valid_len=valid))
    plain_ms, _ = time_ms(torch, lambda i: fa.plain_flash_mha(
        q32, k32, v32, scale=scale, kv_valid_len=valid), iters=10)
    kc, vc = k32[:, :, :valid].contiguous(), v32[:, :, :valid].contiguous()
    qc = q32.contiguous()
    lib_ms, _ = time_ms(torch, lambda i: sdpa(qc, kc, vc, scale=scale))
    # bound_ms: the function's operations at the peak of their type, fp32
    # on the CUDA cores.  route_bound_ms: the kernel's own route, three
    # bf16 tensor-core products per fp32 product, which its design can reach
    n_bytes, flops = 4 * H * Lq * D * 4, 4 * H * Lq * valid * D
    b_ms, b_by = bound(n_bytes, flops, PEAK_FP32_CUDA_CORES)
    r_ms, r_by = bound(n_bytes, 3 * flops, PEAK_BF16_TENSOR)
    print(f"flash fp32 entry: {ms * 1e3:.2f} us; bound {b_ms * 1e3:.2f} us "
          f"(fp32 type), {r_ms * 1e3:.2f} us (3 bf16 products, {r_by})")
    results["flash_attention_f32"] = dict(
        max_abs_err=float((o32 - o32_ref).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        route_bound_ms=r_ms, route_bound_by=r_by, host_call_ms=wall,
        bf16_entry_rel_err=e16)
    del qkv32, q32, k32, v32, kc, vc, qc
    megakernel_phase(torch, results, gen)
    llama_kernel_phase(torch, results, gen)
    santacoder_kernel_phase(torch, results, gen)
    glm_kernel_phase(torch, results, gen)
    beam_phase(torch, results, gen)
    gen_beam_kernel_phase(torch, results)
    gqa_phase(torch, results, gen)
    paged_phase(torch, results, gen)
    window_phase(torch, results, gen)
    paged_beam_phase(torch, results)
    serve_beam_kernel_phase(torch, results)
    fp8_kernel_phase(torch, results)
    int4_phase(torch, results, gen)
    custom_phase(torch, results, gen)
    probes_phase(torch, results, gen)


def random_blobs(torch, dev, gen, n_layer, d):
    """A seeded random int8 weight image for the megakernel at width d
    (ffn 4d), its scales set so that every GEMV output is of order one
    (uniform int8 has std 73.6)."""
    from eddie_wang_hackathon2023_tpu_torch.ops.decoder_layer import (
        MegakernelBlobs, megakernel_tiles)
    L, nf = n_layer, 4
    npan, nflat = 6 + 2 * nf, 3 + nf

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    wblob = torch.randint(-127, 128, (L, npan, d, d), generator=gen,
                          device=dev, dtype=torch.int8)
    pair_scale = (rand(L, 4, d // 128, 128) + 0.5) / (73.6 * d ** 0.5)
    flat_scale = (rand(L, nflat, d) + 0.5) / (73.6 * d ** 0.5)
    flat_scale[:, -1] /= 2.0                      # fc2 sums 4d rows
    ln = randn(L, 6, d) * 0.1
    ln[:, 0::2] += 1.0                            # LN weights near one
    return megakernel_tiles(MegakernelBlobs(
        wblob, pair_scale, randn(L, 4, d // 128, 128) * 0.1, flat_scale,
        randn(L, nflat, d) * 0.1, ln, torch.ones(L, device=dev),
        torch.ones(L, device=dev), None))


def random_whisper_blobs(torch, dev, gen, n_layer, d, weight,
                         values="quantiser"):
    """Seeded random megakernel blobs of Whisper's block at width d (ffn
    4d), packed from a random state and tiled: ``weight`` "int4" (int4
    weight-only, groups of INT4_GROUP rows), "int4_pc" (int4 per channel)
    or "bf16" (float weights N(0, 1 / K)); biases and LayerNorms as
    :func:`random_blobs`'; every GEMV output of order one.  The int4
    ``values``: "quantiser" its range [-7, 7]; "bytes" every byte value
    (-8 in both nibbles included; the values' mean of -0.5 moves the
    residual stream the same way at every layer); "bytes_zero_mean" every
    byte value, each column's scales of a random sign (the weights' mean
    zero)."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    L, ffn, heads = n_layer, 4 * d, d // 64
    st = {}
    for name, k, n in (("attn.qkv", d, 3 * d), ("attn.dense", d, d),
                       ("cross_attn.q_linear", d, d),
                       ("cross_attn.dense", d, d), ("mlp1", d, ffn),
                       ("mlp2", ffn, d)):
        if weight == "bf16":
            shape = (L, 3, heads, 64, d) if name == "attn.qkv" else (L, n, k)
            st[name + ".weight"] = (torch.randn(
                shape, generator=gen, device=dev) * k ** -0.5).bfloat16()
        elif values == "quantiser":
            q = torch.randint(-7, 8, (L, k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            st[name + ".qweight"] = (q[:, :k // 2] & 0xF) | (
                (q[:, k // 2:] & 0xF) << 4)
            del q
        else:
            st[name + ".qweight"] = torch.randint(
                -128, 128, (L, k // 2, n), generator=gen, device=dev,
                dtype=torch.int8)
        if weight != "bf16":
            shape = (L, k // INT4_GROUP, n) if weight == "int4" else (L, n)
            sc = (torch.rand(shape, generator=gen, device=dev) + 0.5) / (
                4.6 * k ** 0.5)
            if values == "bytes_zero_mean":
                sc = sc * (torch.randint(0, 2, (L, 1, n), generator=gen,
                                         device=dev) * 2 - 1).reshape(
                    (L, 1, n) if sc.dim() == 3 else (L, n))
            st[name + ".per_channel_scale"] = sc
        st[name + ".bias"] = 0.1 * torch.randn(
            (L, 3, heads, 64) if name == "attn.qkv" else (L, n),
            generator=gen, device=dev)
    for name in ("attn_ln", "cross_attn_ln", "mlp_ln"):
        st[name + ".weight"] = 1 + 0.1 * torch.randn((L, d), generator=gen,
                                                     device=dev)
        st[name + ".bias"] = 0.1 * torch.randn((L, d), generator=gen,
                                               device=dev)
    blobs = mk.pack_decoder_blobs(st, n_layer=L, hidden=d, n_head=heads,
                                  head_dim=64, ffn=ffn, device=dev)
    del st
    return mk.megakernel_tiles(blobs)


def megakernel_phase(torch, results, gen):
    """Kernel 3, the whole-step decode megakernel, at large-v2 shapes
    (32 layers, d 1280, a self cache of 448 at sequence 44, int8 cross
    cache of 1500), with int8 panels over a bf16 self cache, (kv8) an
    int8 one with per-layer scales and an e4m3 one (its unused columns the
    NaN byte), with int4 panels (groups of 128, and
    per channel) and with bf16 panels: for each, one layer against the
    plain version, then all 32; the steps also timed in turns.  The int4
    modes' one layer takes every byte value (-8 in both nibbles
    included), their 32 layers the quantiser's values."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    dev = torch.device("cuda")
    L, H, D, d, S, Sc, n = 32, 20, 64, 1280, 448, 1500, 44
    scale = D ** -0.5
    blobs = random_blobs(torch, dev, gen, L, d)
    # the int8 self cache's per-layer steps: these blobs' fresh K/V reach
    # about 4 in magnitude; the int8 cache holds the bf16 cache's values
    # at these steps, as a kv8 cache of the same K/V would
    step = torch.full((L,), 4 / 127, device=dev)
    x = torch.randn((1, d), generator=gen, device=dev).bfloat16()
    self16 = torch.randn((L, 1, 2, H, D, S), generator=gen,
                         device=dev).bfloat16()
    self8 = torch.clamp(torch.round(self16.float() * (127 / 4)), -128,
                        127).to(torch.int8)
    # the e4m3 self cache of the same values at the scale 4 / 448, its
    # columns past the valid ones (43 at sequence 44) the NaN byte
    self_f8, s8 = to_e4m3(torch, self16, 4.0)
    nan_past(torch, self_f8, torch.tensor([n - 1]))
    modes = {"decoder_megakernel": (self16, blobs),
             "decoder_megakernel_int8_self": (
                 self8, blobs._replace(kv_oq=1 / step, kv_qo=step)),
             "decoder_megakernel_e4m3_self": (
                 self_f8, blobs._replace(kv_oq=(1 / s8).repeat(L),
                                         kv_qo=s8.repeat(L)))}
    for mode, weight in (("decoder_megakernel_int4", "int4"),
                         ("decoder_megakernel_int4_pc", "int4_pc"),
                         ("decoder_megakernel_bf16", "bf16")):
        t = time.time()
        modes[mode] = (self16, random_whisper_blobs(torch, dev, gen, L, d,
                                                    weight))
        torch.cuda.synchronize()
        print(f"megakernel blobs, {weight} panels: packed and tiled in "
              f"{time.time() - t:.1f} s")
    what_of = {"decoder_megakernel": "int8 panels",
               "decoder_megakernel_int8_self": "int8 panels, int8 self cache",
               "decoder_megakernel_e4m3_self":
                   "int8 panels, e4m3 self cache",
               "decoder_megakernel_int4": "int4 panels, groups of 128",
               "decoder_megakernel_int4_pc": "int4 panels, per channel",
               "decoder_megakernel_bf16": "bf16 panels"}
    cross = torch.randint(-127, 128, (L, 1, 2, H, D, Sc), generator=gen,
                          device=dev, dtype=torch.int8)
    cscale = torch.full((L,), 1 / 40.0, device=dev)
    seq = torch.tensor([n], dtype=torch.int32, device=dev)
    seq_host = seq.cpu()        # the plain version reads the length on the host
    # the int4 modes' one layer on every byte value (a generator of its
    # own: the other modes' inputs stay as they were)
    g1 = torch.Generator(device=dev).manual_seed(SEED + 4)
    one_layer = {mode: random_whisper_blobs(torch, dev, g1, 1, d, weight,
                                            values="bytes")
                 for mode, weight in (("decoder_megakernel_int4", "int4"),
                                      ("decoder_megakernel_int4_pc",
                                       "int4_pc"))}

    def run(mode, n_layer, plain=False):
        self_c, bl = modes[mode]
        if n_layer == 1 and mode in one_layer:
            bl = one_layer[mode]
        b = mk.blob_layers(bl, 0, n_layer)
        if plain:
            return mk.plain_fused_decoder_stack(
                x, b, self_c[:n_layer], seq_host, scale, cross[:n_layer],
                cscale[:n_layer])
        return mk.fused_decoder_stack(x, b, self_c[:n_layer], seq, scale,
                                      cross_cache=cross[:n_layer],
                                      cross_scale=cscale[:n_layer])

    for mode, (self_c, bl) in modes.items():
        what = f"decoder megakernel ({what_of[mode]})"
        errs = {}
        for n_layer, tol in ((1, 1e-2), (L, 5e-2)):
            hid, fresh = run(mode, n_layer)
            hid_p, fresh_p = run(mode, n_layer, plain=True)
            torch.cuda.synchronize()
            errs[n_layer] = (rel_err(hid, hid_p), rel_err(fresh, fresh_p))
            print(f"{what}, {n_layer} layer(s)"
                  + (", every byte value" if n_layer == 1
                     and mode in one_layer else "")
                  + ": rel err vs plain bf16: "
                  f"hidden {errs[n_layer][0]:.3e}, fresh K/V "
                  f"{errs[n_layer][1]:.3e}")
            check(bool(torch.isfinite(hid).all()) and fresh.dtype ==
                  self_c.dtype and within_gate(torch, errs[n_layer], fresh,
                                               n_layer, tol),
                  f"{what}, {n_layer} layer(s), matches plain (rel {tol:g})")
            if self_c.element_size() == 1 and n_layer == 1:
                # one layer: the same bf16 values are quantised on both
                # sides (compared as bytes: e4m3 has no equality kernel)
                check(torch.equal(fresh.view(torch.uint8),
                                  fresh_p.view(torch.uint8)),
                      f"{what}, 1 layer: the fresh {self_c.dtype} K/V equal "
                      "the plain version's")
        ms, wall = time_ms(torch, lambda i: run(mode, L), iters=20)
        # the plain version launches some 300 kernels a layer, more than
        # the launch queue holds for 32 layers: its 32 layers are timed as
        # 32 segments, each layer fed the previous one's hidden state
        hid_box = [x]

        def plain_layer(i):
            b = mk.blob_layers(bl, i, i + 1)
            hid_box[0] = mk.plain_fused_decoder_stack(
                x if i == 0 else hid_box[0], b, self_c[i:i + 1], seq_host,
                scale, cross[i:i + 1], cscale[i:i + 1])[0]

        t = time.perf_counter()
        run(mode, L, plain=True)
        torch.cuda.synchronize()
        plain_host_ms = (time.perf_counter() - t) * 1e3
        plain_runs = [segments_ms(torch, [lambda i=i: plain_layer(i)
                                          for i in range(L)], plain_host_ms)
                      for _ in range(3)]
        if None in plain_runs:
            raise SmokeFailure("the host could not queue the plain "
                               "megakernel's layers ahead of the device")
        plain_ms = sum(plain_runs) / len(plain_runs)
        check(rel_err(hid_box[0], hid_p) < 1e-3,
              f"the plain {what} timed layer by layer computes the 32-layer "
              "result")
        item = self_c.element_size()
        # the bytes a step must move: the panels (int4 two weights a byte;
        # bf16 two bytes a weight) and int4's group scales in bf16, as the
        # tiles hold them and the kernel streams them, the
        # per-channel scales, biases and norms, the caches' valid columns,
        # the row in and out and the fresh K/V
        weights = L * 14 * d * d
        panel_bytes = (weights // 2 if mk.blob_int4(bl) is not None
                       else weights * bl.wblob.element_size())
        gscale_bytes = 0 if bl.gscale is None else bl.gscale.numel() * 2
        aux_bytes = L * (4 * d * 4 * 2 + 7 * d * 4 * 2 + 6 * d * 4 + 4
                         + (8 if item == 1 else 0))
        cache_bytes = L * 2 * H * D * (Sc + (n - 1) * item)
        io_bytes = 2 * d * 2 + L * 2 * H * D * item + 4
        n_bytes = (panel_bytes + gscale_bytes + aux_bytes + cache_bytes
                   + io_bytes)
        b_ms, b_by = bound(n_bytes, 2 * weights + L * 4 * H * D * (n + Sc),
                           PEAK_FP32_CUDA_CORES)
        tiles_mb = bl.tiles.numel() * bl.tiles.element_size() / 1e6
        print(f"{what} step: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us, "
              f"{b_by}; {n_bytes / 1e6:.1f} MB, {tiles_mb:.1f} MB of tiles "
              f"streamed); plain {plain_ms * 1e3:.1f} us (mean of "
              + ", ".join(f"{p * 1e3:.1f}" for p in plain_runs) + ")")
        results[mode] = dict(
            max_abs_err=float((hid - hid_p).float().abs().max()), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, host_call_ms=wall, bytes=n_bytes,
            tiles_mb=tiles_mb,
            grid_blocks=torch.cuda.get_device_properties(0)
            .multi_processor_count,
            rel_err_1_layer=max(errs[1]),
            rel_err_32_layers=max(errs[L]))
    # every mode's step in turns
    turns = []
    for mode in list(modes) * 2:
        turns.append(time_ms(torch, lambda i: run(mode, L), iters=20)[0])
    print("megakernel step in turns, " + " / ".join(
        what_of[m] for m in modes) + ": "
        + ", ".join(f"{t * 1e3:.1f}" for t in turns) + " us")
    for i, mode in enumerate(modes):
        results[mode]["in_turns_ms"] = turns[i::len(modes)]
    # the per-channel int4 mode rides the int4 row (no path reaches it)
    results["decoder_megakernel_int4"]["per_channel"] = results.pop(
        "decoder_megakernel_int4_pc")


# LLaMA-1B (benchmarks/benchmark.py's llama_1b with LLAMA_KW): its
# widths, and the megakernel plans' shape at them
LLAMA_D, LLAMA_FFN, LLAMA_HEADS, LLAMA_LAYERS = 2048, 5504, 16, 16
# the session's cache at the llama path's prompts: bucket 64 + 20 new
# tokens; a mid-call step at sequence 74 from the start 4 (60 of 64)
LLAMA_S, LLAMA_SEQ, LLAMA_START = 84, 74, 4


def random_blobs_of(torch, dev, gen, n_layer, weight, d, ffn, heads,
                    kv_heads, gated, biases):
    """Seeded random megakernel blobs of a decoder-only block: d, ffn,
    heads of d / heads, ``kv_heads`` KV heads (fewer: the grouped mode's
    separate-KV layout), gated or not, with biases (and LayerNorm's) or
    without (RMSNorm's); bf16 panels with unit scales (weights N(0, 1 /
    K)) or int8 weight-only panels with per-channel scales, every GEMV
    output of order one; norm weights 1 + N(0, 0.1)."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    L, H, D = n_layer, heads, d // heads
    dkv = kv_heads * D
    grouped = kv_heads != heads
    st = {}
    mats = [("attention.dense", d, d, None), ("mlp.fc", d, ffn, None),
            ("mlp.proj", ffn, d, None)]
    if gated:
        mats.append(("mlp.gate", d, ffn, None))
    if weight == "int8":
        mats.append(("attention.qkv", d, d + 2 * dkv, None))
    else:
        mats.append(("attention.qkv", d, d, (L, H, D, d) if grouped
                     else (L, 3, H, D, d)))
    for name, k, n, shape in mats:
        if weight == "int8":
            st[name + ".qweight"] = torch.randint(
                -127, 128, (L, k, n), generator=gen, device=dev,
                dtype=torch.int8)
            st[name + ".per_channel_scale"] = (torch.rand(
                (L, n), generator=gen, device=dev) + 0.5) / (73.6 * k ** 0.5)
        else:
            st[name + ".weight"] = (torch.randn(
                shape or (L, n, k), generator=gen, device=dev)
                * k ** -0.5).bfloat16()
        if biases:
            st[name + ".bias"] = 0.1 * torch.randn(
                (L, n if name != "attention.qkv" else d), generator=gen,
                device=dev)
    if weight != "int8" and grouped:
        st["attention.qkv.kv_weight"] = (torch.randn(
            (L, 2, kv_heads, D, d), generator=gen, device=dev)
            * d ** -0.5).bfloat16()
    if biases:
        if grouped:
            st["attention.qkv.kv_bias"] = 0.1 * torch.randn(
                (L, 2, kv_heads, D), generator=gen, device=dev)
        else:
            st["attention.qkv.bias"] = 0.1 * torch.randn(
                (L, 3, H, D), generator=gen, device=dev)
    for name in ("input_layernorm", "post_layernorm"):
        st[name + ".weight"] = 1 + 0.1 * torch.randn(
            (L, d), generator=gen, device=dev)
        if biases:
            st[name + ".bias"] = 0.1 * torch.randn((L, d), generator=gen,
                                                   device=dev)
    blobs = mk.pack_decoder_blobs(
        st, n_layer=L, hidden=d, n_head=H, head_dim=D, ffn=ffn,
        with_cross=False, gated=gated, n_kv_head=kv_heads, device=dev)
    del st
    return mk.megakernel_tiles(blobs)


def llama_blobs(torch, dev, gen, n_layer, weight):
    """Seeded random megakernel blobs at LLaMA-1B's widths (gated, RMSNorm,
    no biases, ffn 5504 padded to 6144; :func:`random_blobs_of`)."""
    return random_blobs_of(torch, dev, gen, n_layer, weight, LLAMA_D,
                           LLAMA_FFN, LLAMA_HEADS, LLAMA_HEADS, True, False)


def megakernel_rows(torch, results, gen, what, rows, shape, blobs_of, kw,
                    params, e4m3_rows=()):
    """The megakernel's decoder-only rows ``rows`` ({row: panels' weight
    type}) at ``shape`` = (L, d, H, Hkv, S, n, start): each row's blobs
    from ``blobs_of(weight)``, one layer and all L against the plain
    version over a seeded bf16 self cache of Hkv heads (at sequence n from
    ``start``; ``kw`` the call's modes; the rows of ``e4m3_rows`` over
    the same values as an e4m3 cache at the scale 4 / 448, its columns
    past the valid ones the NaN byte), the step timed (and the plain
    version layer by layer), its bound from ``params`` (the model's
    weights a step), then the rows' steps in turns."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    dev = torch.device("cuda")
    L, d, H, Hkv, S, n, start = shape
    D = d // H
    scale = D ** -0.5
    x = torch.randn((1, d), generator=gen, device=dev).bfloat16()
    cache = torch.randn((L, 1, 2, Hkv, D, S), generator=gen,
                        device=dev).bfloat16()
    seq = torch.tensor([n], dtype=torch.int32, device=dev)
    start_t = torch.tensor([start], dtype=torch.int32, device=dev)
    kw = dict(kw, start_index=start_t, head_dim=D)
    # the plain version reads the length and the start on the host
    seq_host = seq.cpu()
    kw_plain = {k: v for k, v in kw.items() if k != "gated"}
    kw_plain["start_index"] = start_t.cpu()
    cache8, s8 = to_e4m3(torch, cache, 4.0)
    nan_past(torch, cache8, torch.tensor([n - 1]))
    caches = {row: cache8 if row in e4m3_rows else cache for row in rows}
    modes = {}
    for row, weight in rows.items():
        t = time.time()
        modes[row] = blobs_of(weight)
        if row in e4m3_rows:
            modes[row] = modes[row]._replace(
                kv_oq=(1 / s8).repeat(L), kv_qo=s8.repeat(L))
        torch.cuda.synchronize()
        print(f"{what} megakernel blobs, {weight} panels: packed and "
              f"tiled in {time.time() - t:.1f} s")

    def run(row, n_layer, plain=False):
        b = mk.blob_layers(modes[row], 0, n_layer)
        c = caches[row][:n_layer]
        if plain:
            return mk.plain_fused_decoder_stack(
                x, b, c, seq_host, scale, **kw_plain)
        return mk.fused_decoder_stack(x, b, c, seq, scale, **kw)

    for row, blobs in modes.items():
        weight = "int8" if blobs.wblob.dtype == torch.int8 else "bf16"
        label = f"{what} megakernel, {weight} panels" + (
            ", e4m3 self cache" if row in e4m3_rows else "")
        errs = {}
        for n_layer, tol in ((1, 1e-2), (L, 5e-2)):
            hid, fresh = run(row, n_layer)
            hid_p, fresh_p = run(row, n_layer, plain=True)
            torch.cuda.synchronize()
            errs[n_layer] = (rel_err(hid, hid_p), rel_err(fresh, fresh_p))
            print(f"{label}, {n_layer} layer(s): rel err vs plain bf16: "
                  f"hidden {errs[n_layer][0]:.3e}, fresh K/V "
                  f"{errs[n_layer][1]:.3e}")
            check(bool(torch.isfinite(hid).all()) and fresh.dtype ==
                  caches[row].dtype and fresh.shape == (n_layer, 2, Hkv, D)
                  and within_gate(torch, errs[n_layer], fresh, n_layer,
                                  tol),
                  f"{label}, {n_layer} layer(s), matches plain (rel {tol:g})")
        ms, wall = time_ms(torch, lambda i: run(row, L), iters=20)
        hid_box = [x]

        def plain_layer(i):
            b = mk.blob_layers(blobs, i, i + 1)
            hid_box[0] = mk.plain_fused_decoder_stack(
                hid_box[0] if i else x, b, caches[row][i:i + 1], seq_host,
                scale, **kw_plain)[0]

        t = time.perf_counter()
        run(row, L, plain=True)
        torch.cuda.synchronize()
        plain_host_ms = (time.perf_counter() - t) * 1e3
        plain_runs = [segments_ms(torch, [lambda i=i: plain_layer(i)
                                          for i in range(L)], plain_host_ms)
                      for _ in range(3)]
        if None in plain_runs:
            raise SmokeFailure("the host could not queue the plain "
                               "megakernel's layers ahead of the device")
        plain_ms = sum(plain_runs) / len(plain_runs)
        check(rel_err(hid_box[0], hid_p) < 1e-3,
              f"the plain {label} timed layer by layer computes the "
              f"{L}-layer result")
        # the bound counts the model's own weights (not the ffn's zero
        # padding, which the kernel streams), int8's per-channel scales,
        # the norms' parameters, the valid cache columns, the row in and
        # out and the fresh K/V
        item = blobs.wblob.element_size()
        c_item = caches[row].element_size()
        n_cols = sum(params["cols"])
        n_bytes = (params["weights"] * item
                   + (L * n_cols * 4 if item == 1 else 0)
                   + L * params["norm_rows"] * d * 4
                   + L * 2 * Hkv * D * (n - 1 - start) * c_item
                   + 2 * d * 2 + L * 2 * Hkv * D * c_item + 8
                   + (L * 8 if c_item == 1 else 0))
        b_ms, b_by = bound(n_bytes, 2 * params["weights"]
                           + L * 4 * H * D * (n - start),
                           PEAK_FP32_CUDA_CORES)
        tiles_mb = blobs.tiles.numel() * item / 1e6
        print(f"{label} step: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us, "
              f"{b_by}; {n_bytes / 1e6:.1f} MB, {tiles_mb:.1f} MB of tiles "
              f"streamed); plain {plain_ms * 1e3:.1f} us (mean of "
              + ", ".join(f"{p * 1e3:.1f}" for p in plain_runs) + ")")
        _, gated, nf = mk.blob_layout(blobs)
        results[row] = dict(
            max_abs_err=float((hid - hid_p).float().abs().max()), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, host_call_ms=wall, tiles_mb=tiles_mb,
            rel_err_1_layer=max(errs[1]), rel_err_all_layers=max(errs[L]),
            plan=mk.megakernel_plan(d, nf, torch.cuda.get_device_properties(
                0).multi_processor_count, False, gated, item, Hkv * D))
    turns = []
    for row in list(modes) * 2:
        turns.append(time_ms(torch, lambda i: run(row, L), iters=20)[0])
    print(f"{what} megakernel step in turns, "
          + " / ".join(rows) + ": "
          + ", ".join(f"{t * 1e3:.1f}" for t in turns) + " us")
    for i, row in enumerate(rows):
        results[row]["in_turns_ms"] = turns[i::len(rows)]


def decode_attention_row(torch, results, gen, row, shape, starts):
    """Kernel 1's self call at ``shape`` = (L, B, H, D, S, n): a bf16
    cache, every row at sequence n from its own start (``starts``), the
    fresh K/V, L layers rotating; against its plain version (bf16 and
    fp32), timed beside the plain version and SDPA over the valid columns
    and the fresh one laid out beforehand (a row's own columns: the rows
    of different starts are timed as one batch of the longest)."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    L, B, H, D, S, n = shape
    scale = D ** -0.5
    q = torch.randn((B, H, 1, D), generator=gen, device=dev).bfloat16()
    self_c = torch.randn((L, B, 2, H, D, S), generator=gen,
                         device=dev).bfloat16()
    fresh = tuple(torch.randn((B, H, D, 1), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
    seq_b = torch.full((B,), n, dtype=torch.int32, device=dev)
    start_b = torch.tensor(starts, dtype=torch.int32, device=dev)
    kw1 = dict(fresh_kv=fresh, start_index=start_b)
    out = da.fused_decode_attention(self_c, 3, q, seq_b, scale, **kw1)
    ref16 = da.plain_decode_attention(self_c, 3, q, seq_b, scale, **kw1)
    ref32 = da.plain_decode_attention(
        self_c.float(), 3, q.float(), seq_b, scale,
        fresh_kv=tuple(t.float() for t in fresh), start_index=start_b)
    torch.cuda.synchronize()
    e16, e32 = rel_err(out, ref16), rel_err(out, ref32)
    what = f"decode attention at head dim {D} ({row})"
    print(f"{what} (batch {B}, {H} heads, S {S}, seq {n}, starts "
          f"{list(starts)}): rel err vs plain bf16 {e16:.3e}, vs fp32 "
          f"{e32:.3e}")
    check(e16 < 2e-2 and e32 < 1e-2,
          f"{what} matches plain (rel 2e-2 bf16, 1e-2 fp32)")
    ms, wall = time_ms(torch, lambda i: da.fused_decode_attention(
        self_c, i % L, q, seq_b, scale, **kw1))
    plain_ms, _ = time_ms(torch, lambda i: da.plain_decode_attention(
        self_c, i % L, q, seq_b, scale, **kw1))
    lo = min(starts)
    k_sd, v_sd = (torch.cat(
        [self_c[:, :, j, :, :, lo:n - 1],
         fresh[j][None].expand(L, -1, -1, -1, -1)],
        dim=-1).transpose(-1, -2).contiguous() for j in (0, 1))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms, _ = time_ms(torch, lambda i: sdpa(q, k_sd[i % L], v_sd[i % L],
                                              scale=scale))
    cols = sum(n - 1 - s for s in starts)
    b_ms, b_by = bound(2 * H * D * cols * 2 + 2 * B * H * D * 2
                       + 2 * B * H * D * 2 + B * 8,
                       4 * H * D * (cols + B), PEAK_FP32_CUDA_CORES)
    print(f"{what}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us, {b_by}); "
          f"plain {plain_ms * 1e3:.2f} us, SDPA {lib_ms * 1e3:.2f} us")
    results[row] = dict(
        max_abs_err=float((out.float() - ref32).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        host_call_ms=wall, **split_of(da, S))


def llama_kernel_phase(torch, results, gen):
    """The megakernel's decoder-only modes at LLaMA-1B's shape (16 layers,
    d 2048, 16 heads of 128, ffn 5504, RMSNorm, the gated SiLU MLP, RoPE
    over every channel, a bf16 self cache of 84 at sequence 74 from start
    4), bf16 and int8 panels: one layer and all 16 against the plain
    version, the step timed (the two in turns); then kernel 1 at head dim
    128 at the batch-8 path's shape, against its plain version, beside
    SDPA."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    dev = torch.device("cuda")
    L, d, ffn, H = LLAMA_LAYERS, LLAMA_D, LLAMA_FFN, LLAMA_HEADS
    D, S, n, start = d // H, LLAMA_S, LLAMA_SEQ, LLAMA_START
    megakernel_rows(
        torch, results, gen, "LLaMA-1B",
        {"decoder_megakernel_llama": "bf16",
         "decoder_megakernel_llama_woq8": "int8",
         "decoder_megakernel_llama_e4m3": "bf16"},
        (L, d, H, H, S, n, start),
        lambda weight: llama_blobs(torch, dev, gen, L, weight),
        dict(act="silu", norm="rmsnorm", gated=True,
             rope=mk.Rotary(n - 1, D, 10000.0, True)),
        dict(weights=L * (4 * d * d + 3 * d * ffn),
             cols=(3 * d, d, 2 * ffn, d), norm_rows=2),
        e4m3_rows=("decoder_megakernel_llama_e4m3",))
    # kernel 1 at head dim 128: the batch-8 path's self call (16 heads of
    # 128, a bf16 cache of 84, every row at sequence 74 from start 4, the
    # fresh K/V), 16 layers
    decode_attention_row(torch, results, gen, "decode_attention_d128",
                         (L, DEC_BATCH, H, D, S, n), [start] * DEC_BATCH)


# SantaCoder-1B (benchmarks/benchmark.py's santacoder_1b): 24 layers, d
# 2048, 16 query heads of 128 over one KV head, ffn 8192, vocab 49152
SANTA_LAYERS, SANTA_D, SANTA_HEADS, SANTA_FFN = 24, 2048, 16, 8192


def santacoder_kernel_phase(torch, results, gen):
    """The megakernel's grouped (MQA) mode at SantaCoder-1B's shape (24
    layers, d 2048, 16 query heads of 128 over one KV head, ffn 8192,
    LayerNorm, tanh GELU, biases, a bf16 self cache of 84 one head wide at
    sequence 74 from start 4: the batch-1 path's mid-call step), bf16 and
    int8 panels, as :func:`llama_kernel_phase` holds LLaMA-1B's."""
    dev = torch.device("cuda")
    L, d, H, ffn = SANTA_LAYERS, SANTA_D, SANTA_HEADS, SANTA_FFN
    dkv = d // H
    megakernel_rows(
        torch, results, gen, "SantaCoder-1B (MQA)",
        {"decoder_megakernel_mqa": "bf16",
         "decoder_megakernel_mqa_woq8": "int8"},
        (L, d, H, 1, LLAMA_S, LLAMA_SEQ, LLAMA_START),
        lambda weight: random_blobs_of(torch, dev, gen, L, weight, d, ffn,
                                       H, 1, False, True),
        dict(act="gelu", norm="layernorm"),
        dict(weights=L * (2 * d * d + 2 * d * dkv + 2 * d * ffn),
             cols=(d + 2 * dkv, d, ffn, d), norm_rows=4))


# ChatGLM-6B (THUDM/chatglm-6b config.json): 28 layers, d 4096, 32 heads of
# 128, inner 16384, vocab 130528
GLM_LAYERS, GLM_D, GLM_HEADS, GLM_FFN, GLM_VOCAB = 28, 4096, 32, 16384, 130528
# the chatglm path's prompts: true lengths of 60 down to 32 (bucket 64)
GLM_PROMPTS = (60, 56, 52, 48, 44, 40, 36, 32)


def glm_kernel_phase(torch, results, gen):
    """Kernel 1 at ChatGLM-6B's decode shape: batch 8, 32 heads of 128, a
    bf16 cache of 84 at sequence 74, each row from its own start (prompts
    of GLM_PROMPTS tokens bucketed to 64), 28 layers rotating."""
    decode_attention_row(
        torch, results, gen, "decode_attention_glm",
        (GLM_LAYERS, len(GLM_PROMPTS), GLM_HEADS, GLM_D // GLM_HEADS,
         LLAMA_S, LLAMA_SEQ), [64 - p for p in GLM_PROMPTS])


def beam_numbers(torch, da, cache, q, seq, fresh, ind, n, start=None,
                 kscale=None):
    """Time the beam entry at a path's shapes (groups of beams, the rows
    grouped by group), rotating over the cache's layers: its time, its
    plain version's (some 40 kernels a call, so 10 calls fit in the launch
    queue behind the spin), and the library's, SDPA over the K/V gathered
    through the table beforehand with the fresh column appended (the
    gather, one layer, timed on its own); its bound.  ``seq`` is ``n`` for every beam, ``start`` the first
    valid column for all (None: 0); ``kscale`` a quantised cache's dequant
    scale (its K/V dequantised to bf16 before the gather, which is not
    timed)."""
    L, _, _, H, D, S = cache.shape
    bw = ind.shape[1]
    scale = D ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lo = 0 if start is None else int(start[0])
    kw = dict(fresh_kv=fresh, beam_indirection=ind, start_index=start,
              kv_quant_orig_scale=kscale)
    ms, wall = time_ms(torch, lambda i: da.fused_decode_attention(
        cache, i % L, q, seq, scale, **kw))
    plain_ms, _ = time_ms(torch, lambda i: da.plain_beam_decode_attention(
        cache, i % L, q, seq, scale, **kw), iters=10)

    def gather_kv(layer):
        g = ind.shape[0]
        idx = ind.long() + torch.arange(g, device=q.device)[:, None, None] \
            * bw
        c = cache[layer]
        f = fresh
        if kscale is not None:
            c = (c.float() * kscale).bfloat16()
            f = tuple((t.float() * kscale).bfloat16() for t in fresh)
        kv = torch.gather(c, 0, idx.reshape(g * bw, 1, 1, 1, S).expand(
            c.shape))[..., lo:n - 1]                      # [bw,2,H,D,n-1-lo]
        return tuple(torch.cat([kv[:, j], f[j]], dim=-1).transpose(
            -1, -2).contiguous() for j in (0, 1))          # [bw,H,keys,D]

    gather_ms, _ = time_ms(torch, lambda i: gather_kv(i % L), iters=10)
    k_g, v_g = (torch.stack(t) for t in zip(*(gather_kv(i)
                                               for i in range(L))))
    lib_ms, _ = time_ms(torch, lambda i: sdpa(q, k_g[i % L], v_g[i % L],
                                              scale=scale))
    lib_err = rel_err(sdpa(q, k_g[3], v_g[3], scale=scale),
                      da.fused_decode_attention(cache, 3, q, seq, scale,
                                                **kw))
    del k_g, v_g
    # bytes: the K and V of the (source row, valid column) pairs the table
    # points at, q, the fresh K/V, the table's valid columns, the lengths
    # (and starts), the output; operations: 4 per (query beam, valid key,
    # d), on bf16 operands.  Beside it the bound with every source row read
    # at every valid column (what this design stages)
    cols = n - 1 - lo
    item = cache.element_size()
    pairs = table_pairs(torch, ind, lo, n - 1)
    rows = q.shape[0]
    rest = (rows * H * D * 2 + 2 * rows * H * D * item + rows * cols * 4
            + rows * 4 * (1 if start is None else 2) + rows * H * D * 2
            + (4 if kscale is not None else 0))
    flops = 4 * rows * H * D * (cols + 1)
    n_bytes = 2 * H * D * item * pairs + rest
    b_ms, b_by = bound(n_bytes, flops, PEAK_BF16_TENSOR)
    all_bytes = 2 * H * D * item * rows * cols + rest
    all_ms, _ = bound(all_bytes, flops, PEAK_BF16_TENSOR)
    plan = da.beam_plan(S, bw, D, item)
    print(f"beam decode (beam {bw}, {H} heads, S={S}, seq {n}, start {lo}): "
          f"plan {plan}; the table points at {pairs} of {rows * cols} "
          f"(row, column) pairs")
    print(f"beam decode: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us, "
          f"{b_by}, {n_bytes / 1e6:.3f} MB; every row at every column "
          f"{all_ms * 1e3:.3f} us, {all_bytes / 1e6:.3f} MB); plain "
          f"{plain_ms * 1e3:.2f} us; SDPA on the gathered K/V "
          f"{lib_ms * 1e3:.2f} us (rel err vs the kernel {lib_err:.3e}) + "
          f"the gather {gather_ms * 1e3:.2f} us")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_all_rows_ms=all_ms, table_pairs=pairs,
                table_pair_share=pairs / (rows * cols),
                library_ms=lib_ms, library_gather_ms=gather_ms,
                host_call_ms=wall, plan=plan)


def table_pairs(torch, ind, lo, hi):
    """The distinct (source row, column) pairs that the indirection table
    ``ind`` [groups, beams, S] points at in the columns [lo, hi): the K/V
    that a beam step over those columns must read."""
    g, bw, _ = ind.shape
    hit = torch.zeros((g, bw, hi - lo), dtype=torch.bool, device=ind.device)
    hit.scatter_(1, ind[..., lo:hi].long(), True)
    return int(hit.sum())


def gen_beam_kernel_phase(torch, results):
    """The beam entry at the gen_beam path's shape (GPT-350M: 24 layers of
    16 heads of 64, bf16, beam 4, a cache of 2088 columns, the prompt's
    valid columns from 136, sequence 2068: the middle step of a 40-token
    call) against its plain version, with a table whose rows change from
    position to position; timed with its bound, the plain version's time
    and the library's (:func:`beam_numbers`).  Its own generator keeps the
    other phases' draws as they were."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    L, bw, H, D = 24, GEN_BEAM_WIDTH, 16, 64
    S, lo, n = 2048 + GEN_BEAM_NEW[1], 136, 2048 + GEN_BEAM_NEW[1] // 2
    scale = D ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q = randn(bw, H, 1, D)
    cache = randn(L, bw, 2, H, D, S)           # 824 MB, past the 50 MB L2
    fresh = (randn(bw, H, D, 1), randn(bw, H, D, 1))
    ind = torch.randint(0, bw, (1, bw, S), generator=gen, device=dev,
                        dtype=torch.int32)
    seq = torch.full((bw,), n, dtype=torch.int32, device=dev)
    start = torch.full((bw,), lo, dtype=torch.int32, device=dev)
    kw = dict(fresh_kv=fresh, beam_indirection=ind, start_index=start)
    out = da.fused_decode_attention(cache, 3, q, seq, scale, **kw)
    ref = da.plain_beam_decode_attention(cache, 3, q, seq, scale, **kw)
    ref32 = da.plain_beam_decode_attention(
        cache[3:4].float(), 0, q.float(), seq, scale,
        fresh_kv=tuple(t.float() for t in fresh), beam_indirection=ind,
        start_index=start)
    torch.cuda.synchronize()
    e16, e32 = rel_err(out, ref), rel_err(out, ref32)
    print(f"beam decode (gen_beam shape): rel err vs plain bf16 {e16:.3e}, "
          f"vs fp32 {e32:.3e}")
    check(e16 < 2e-2 and e32 < 1e-2,
          f"beam decode attention (beam {bw}, {H} heads, S={S}, seq {n}, "
          f"start {lo}) matches plain (rel 2e-2 bf16, 1e-2 fp32)")
    results["beam_decode_attention_gen"] = dict(
        max_abs_err=float((out.float() - ref32).abs().max()),
        rel_err_vs_plain=(e16, e32),
        **beam_numbers(torch, da, cache, q, seq, fresh, ind, n, start))


def beam_phase(torch, results, gen):
    """The beam entry of the decode kernel at the beam path's shapes (beam
    5, 20 heads of 64, bf16 self cache of 448 at sequence 44, a table whose
    rows change from position to position) against its plain version, then
    an int8 cache and two groups; and kernel 1's cross call at batch 5 (the
    repeated int8 cross cache of 1500), as the beam path makes it."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    L, bw, H, D, S, n = 32, BEAM_SIZE, 20, 64, 448, 44
    scale = D ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def table(groups):
        return torch.randint(0, bw, (groups, bw, S), generator=gen,
                             device=dev, dtype=torch.int32)

    q = randn(bw, H, 1, D)
    cache = randn(L, bw, 2, H, D, S)           # 367 MB, past the 50 MB L2
    fresh = (randn(bw, H, D, 1), randn(bw, H, D, 1))
    ind = table(1)
    seq = torch.full((bw,), n, dtype=torch.int32, device=dev)

    def beam_call(c, layer, q_, seq_, fresh_, ind_, impl, **kw):
        return impl(c, layer, q_, seq_, scale, fresh_kv=fresh_,
                    beam_indirection=ind_, **kw)

    cases = [("bf16, 1 group, seq 44", cache, q, seq, fresh, ind, {})]
    c8 = torch.randint(-127, 128, (1, bw, 2, H, D, S), generator=gen,
                       device=dev, dtype=torch.int8)
    f8 = tuple(torch.randint(-127, 128, (bw, H, D, 1), generator=gen,
                             device=dev, dtype=torch.int8) for _ in range(2))
    cases.append(("int8, 1 group, seq 44", c8, q, seq, f8, ind,
                  dict(kv_quant_orig_scale=torch.tensor(1 / 40.0,
                                                        device=dev))))
    q2 = randn(2 * bw, H, 1, D)
    c2 = randn(1, 2 * bw, 2, H, D, S)
    f2 = (randn(2 * bw, H, D, 1), randn(2 * bw, H, D, 1))
    seq2 = torch.tensor([n, 300], dtype=torch.int32,
                        device=dev).repeat_interleave(bw)
    cases.append(("bf16, 2 groups, seq 44 and 300", c2, q2, seq2, f2,
                  table(2), {}))
    errs = {}
    for what, c, q_, seq_, f_, ind_, kw in cases:
        layer = min(3, c.shape[0] - 1)
        out = beam_call(c, layer, q_, seq_, f_, ind_,
                        da.fused_decode_attention, **kw)
        ref = beam_call(c, layer, q_, seq_, f_, ind_,
                        da.plain_beam_decode_attention, **kw)
        f32 = (lambda t: t) if c.dtype == torch.int8 else (
            lambda t: t.float())
        ref32 = beam_call(f32(c), layer, q_.float(), seq_,
                          tuple(f32(t) for t in f_), ind_,
                          da.plain_beam_decode_attention, **kw)
        torch.cuda.synchronize()
        e16, e32 = rel_err(out, ref), rel_err(out, ref32)
        errs[what] = (e16, e32, float((out.float() - ref32).abs().max()))
        print(f"beam decode ({what}): rel err vs plain bf16 {e16:.3e}, vs "
              f"fp32 {e32:.3e}")
        check(e16 < 2e-2 and e32 < 1e-2,
              f"beam decode attention ({what}, beam {bw}, S={S}) matches "
              "plain (rel 2e-2 bf16, 1e-2 fp32)")
    del c8, f8, q2, c2, f2
    nums = beam_numbers(torch, da, cache, q, seq, fresh, ind, n)
    first = errs["bf16, 1 group, seq 44"]
    results["beam_decode_attention"] = dict(
        max_abs_err=first[2], **nums,
        rel_err_vs_plain={k: v[:2] for k, v in errs.items()})
    del cache

    # kernel 1, cross-attention at batch 5: the int8 cross cache repeated
    # per beam, S=1500, no out-projection (batch > 1); 8 layers rotate
    # (154 MB, past the L2)
    Lc, Sc = 8, 1500
    cross = torch.randint(-127, 128, (Lc, bw, 2, H, D, Sc), generator=gen,
                          device=dev, dtype=torch.int8)
    cscale = torch.full((Lc,), 1 / 40.0, device=dev)
    s_full = torch.full((bw,), Sc, dtype=torch.int32, device=dev)
    out = da.fused_decode_attention(cross, 3, q, s_full, scale,
                                    kv_quant_orig_scale=cscale[3])
    ref = da.plain_decode_attention(cross, 3, q, s_full, scale,
                                    kv_quant_orig_scale=cscale[3])
    ref32 = da.plain_decode_attention(cross, 3, q.float(), s_full, scale,
                                      kv_quant_orig_scale=cscale[3])
    torch.cuda.synchronize()
    e16, e32 = rel_err(out, ref), rel_err(out, ref32)
    print(f"decode cross at batch {bw}: rel err vs plain bf16 {e16:.3e}, "
          f"vs fp32 {e32:.3e}")
    check(e16 < 2e-2 and e32 < 1e-2,
          f"decode attention (int8 cross, batch {bw}, S={Sc}) matches plain "
          "(rel 2e-2 bf16, 1e-2 fp32)")
    ms, wall = time_ms(torch, lambda i: da.fused_decode_attention(
        cross, i % Lc, q, s_full, scale, kv_quant_orig_scale=cscale[i % Lc]))
    plain_ms, _ = time_ms(torch, lambda i: da.plain_decode_attention(
        cross, i % Lc, q, s_full, scale, kv_quant_orig_scale=cscale[i % Lc]))
    kd = cross.float().mul(1 / 40.0).to(torch.bfloat16)   # [Lc,bw,2,H,D,S]
    k_sd = kd[:, :, 0].transpose(-1, -2).contiguous()
    v_sd = kd[:, :, 1].transpose(-1, -2).contiguous()
    del kd
    lib_ms, _ = time_ms(torch, lambda i: sdpa(q, k_sd[i % Lc], v_sd[i % Lc],
                                              scale=scale))
    del k_sd, v_sd, cross
    n_bytes = 2 * bw * H * D * Sc + 2 * 2 * bw * H * D + bw * 4 + 4
    b_ms, b_by = bound(n_bytes, 4 * bw * H * D * Sc, PEAK_FP32_CUDA_CORES)
    print(f"decode cross at batch {bw}: {ms * 1e3:.2f} us (bound "
          f"{b_ms * 1e3:.3f} us, {b_by}, {n_bytes / 1e6:.2f} MB); plain "
          f"{plain_ms * 1e3:.2f} us; SDPA {lib_ms * 1e3:.2f} us")
    results["decode_attention_int8_b5"] = dict(
        max_abs_err=float((out.float() - ref32).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        host_call_ms=wall, **split_of(da, Sc))


def gqa_phase(torch, results, gen):
    """The grouped (MQA/GQA) decode kernel against its plain version: at the
    decoder path's shapes (batch 8, one KV head under 16 query heads of 128,
    a bf16 cache of S = 64 + 20 = 84 at sequence 70, start 4), at a GQA
    shape (4 KV heads under 4 query heads each, head dim 64, S = 83, two
    rows of different lengths and starts), with an int8 cache and with a
    long cache that the kernel splits over a cluster (S 2063, 8 slices, by
    element copies; S 1500, 8 slices, by 4-column copies);
    then timed at the path's shapes against its plain version and SDPA
    (``enable_gqa``) on K/V transposed beforehand.  The split at the path's
    S is the wrapper's ``gqa_splits`` and ``gqa_slice_width``, which it
    passes to the kernel."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    L, B, Hkv, rep, D = 24, DEC_BATCH, 1, 16, 128
    S, n, st = 64 + DEC_NEW, 70, 4
    ks8 = 1 / 40.0

    def rand(shape, int8):
        if int8:
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def rows(vals, b):
        return torch.tensor(vals, dtype=torch.int32, device=dev).repeat(
            b // len(vals))

    def case(b, hkv, r, d, s, seqs, starts, int8, layers=1):
        """(cache, q, seq, fresh K/V, start, kwargs) of one call"""
        fresh = tuple(rand((b, hkv, d, 1), int8) for _ in range(2))
        kw = dict(scale=d ** -0.5, kv_quant_orig_scale=(
            torch.tensor(ks8, device=dev) if int8 else None))
        return (rand((layers, b, 2, hkv, d, s), int8),
                rand((b, hkv * r, 1, d), False), rows(seqs, b), fresh,
                rows(starts, b), kw)

    def call(impl, c, layer, q, seq, fresh, start, kw):
        return impl(c, layer, q, seq, kw["scale"],
                    kv_quant_orig_scale=kw["kv_quant_orig_scale"],
                    fresh_kv=fresh, start_index=start)

    path = case(B, Hkv, rep, D, S, [n], [st], False, layers=L)
    cases = {
        "path: bf16, 1 KV head x 16, D 128, S 84, seq 70, start 4": path,
        "GQA: bf16, 4 KV heads x 4, D 64, S 83, seq 30/83, start 0/7":
            case(2, 4, 4, 64, 83, [30, 83], [0, 7], False),
        "int8, 1 KV head x 16, D 128, S 84, seq 70, start 4":
            case(B, Hkv, rep, D, S, [n], [st], True),
        # a long cache, split over a cluster of 8 (slices of 272): a row
        # over all of S, one whose start skips the first slice
        "long: bf16, 2 KV heads x 16, D 64, S 2063, seq 2063/546, start "
        "5/272": case(2, 2, 16, 64, 2063, [2063, 546], [5, 272], False),
        # the same with S % 4 == 0 (slices of 192, staged 4 columns a
        # copy): a start and a last cached column inside a 4-column group
        "long: int8, 2 KV heads x 16, D 128, S 1500, seq 1499/419, start "
        "3/193": case(2, 2, 16, 128, 1500, [1499, 419], [3, 193], True),
    }
    errs = {}
    for what, (c, q, seq, fresh, start, kw) in cases.items():
        layer = c.shape[0] - 1
        out = call(da.fused_decode_attention, c, layer, q, seq, fresh, start,
                   kw)
        ref = call(da.plain_gqa_decode_attention, c, layer, q, seq, fresh,
                   start, kw)
        f32 = (lambda t: t) if c.dtype == torch.int8 else (
            lambda t: t.float())
        ref32 = call(da.plain_gqa_decode_attention, f32(c), layer, q.float(),
                     seq, tuple(f32(t) for t in fresh), start, kw)
        torch.cuda.synchronize()
        e16, e32 = rel_err(out, ref), rel_err(out, ref32)
        errs[what] = (e16, e32, float((out.float() - ref32).abs().max()))
        print(f"grouped decode ({what}): rel err vs plain bf16 {e16:.3e}, vs "
              f"fp32 {e32:.3e}")
        check(bool(torch.isfinite(out).all()) and e16 < 2e-2 and e32 < 1e-2,
              f"grouped decode attention ({what}) matches plain (rel 2e-2 "
              "bf16, 1e-2 fp32)")
    # timed at the path's shapes, rotating over the 24 layers
    cache, q, seq, fresh, start, kw = path
    ms, wall = time_ms(torch, lambda i: call(
        da.fused_decode_attention, cache, i % L, q, seq, fresh, start, kw))
    plain_ms, _ = time_ms(torch, lambda i: call(
        da.plain_gqa_decode_attention, cache, i % L, q, seq, fresh, start,
        kw), iters=10)

    # library: SDPA with enable_gqa over each layer's valid columns and the
    # fresh one, transposed to [B, Hkv, n, D] beforehand (timed on its own),
    # keys below the start masked
    def transposed(layer):
        return tuple(torch.cat([cache[layer, :, j, :, :, :n - 1], fresh[j]],
                               dim=-1).transpose(-1, -2).contiguous()
                     for j in (0, 1))

    t_ms, _ = time_ms(torch, lambda i: transposed(i % L), iters=10)
    k_t, v_t = (torch.stack(t) for t in zip(*(transposed(i)
                                               for i in range(L))))
    mask = (torch.arange(n, device=dev)[None, :] >= start[:, None])[
        :, None, None, :]
    lib_ms, _ = time_ms(torch, lambda i: sdpa(
        q, k_t[i % L], v_t[i % L], attn_mask=mask, scale=kw["scale"],
        enable_gqa=True))
    lib_err = rel_err(sdpa(q, k_t[L - 1], v_t[L - 1], attn_mask=mask,
                           scale=kw["scale"], enable_gqa=True),
                      call(da.fused_decode_attention, cache, L - 1, q, seq,
                           fresh, start, kw))
    del k_t, v_t
    # bytes: each KV head's valid columns (start to seq - 2) of K and V read
    # once for its rep query heads, the fresh K/V, q, the lengths and starts,
    # the output; operations: 4 per (query head, key, d) over the valid keys
    # and the fresh one
    valid = n - 1 - st
    n_bytes = (2 * B * Hkv * D * valid * 2 + 2 * B * Hkv * D * 2
               + B * Hkv * rep * D * 2 * 2 + 2 * B * 4)
    b_ms, b_by = bound(n_bytes, 4 * B * Hkv * rep * D * (valid + 1),
                       PEAK_BF16_TENSOR)
    # the split the wrapper passes to the kernel at the path's S
    split = dict(splits=da.gqa_splits(S),
                 slice=da.gqa_slice_width(S, da.gqa_splits(S)))
    print(f"grouped decode: split {split} at S {S}; {ms * 1e3:.2f} us "
          f"(bound {b_ms * 1e3:.3f} us, "
          f"{b_by}, {n_bytes / 1e6:.3f} MB); plain {plain_ms * 1e3:.2f} us; "
          f"SDPA (enable_gqa) on the transposed K/V {lib_ms * 1e3:.2f} us "
          f"(rel err vs the kernel {lib_err:.3e}) + the transpose "
          f"{t_ms * 1e3:.2f} us")
    first = errs[next(iter(cases))]
    results["gqa_decode_attention"] = dict(
        max_abs_err=first[2], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_transpose_ms=t_ms,
        host_call_ms=wall, **split,
        rel_err_vs_plain={k: v[:2] for k, v in errs.items()})


def paged_phase(torch, results, gen):
    """The paged decode kernel against its plain version: at the serve
    path's shapes (8 rows, a bf16 pool of 24 layers x 32 blocks of 32
    tokens, 16 KV heads of 64, ragged lengths 61-80, each row's blocks a
    permuted draw, -1 past its length) and at MQA shapes with an int8 pool
    (one KV head under 16 query heads of 128); then both timed against
    their plain versions and SDPA on K/V gathered through the table
    beforehand (the gather timed on its own)."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    L, N, T, B, MB = 24, 32, SERVE_BLOCK, SERVE_SLOTS, SERVE_MAX_SEQ // \
        SERVE_BLOCK

    def case(hkv, rep, d, int8):
        """(pool, q, table, seq, kwargs) of one call"""
        shape = (L, N, 2, hkv, T, d)
        pool = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) if int8 else
                torch.randn(shape, generator=gen, device=dev).bfloat16())
        q = torch.randn((B, hkv * rep, 1, d), generator=gen,
                        device=dev).bfloat16()
        seq = torch.randint(SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_NEW + 1,
                            (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        table = torch.randperm(N, generator=gen, device=dev).to(
            torch.int32).reshape(B, MB)
        need = (seq + T - 1) // T
        table = torch.where(torch.arange(MB, device=dev)[None, :]
                            < need[:, None], table, -1)
        kw = dict(scale=d ** -0.5, kv_quant_orig_scale=(
            torch.tensor(1 / 40.0, device=dev) if int8 else None))
        return pool, q, table, seq, kw

    def call(impl, pool, layer, q, table, seq, kw):
        return impl(pool, layer, q, table, seq, kw["scale"],
                    kv_quant_orig_scale=kw["kv_quant_orig_scale"])

    def gathered(pool, layer, table, kw):
        """one layer's K and V through the table, [B, Hkv, MB*T, D] bf16"""
        blocks = pool[layer][table.long().clamp(min=0)]   # [B,MB,2,Hkv,T,D]
        if pool.dtype == torch.int8:
            blocks = (blocks.float() * kw["kv_quant_orig_scale"]).bfloat16()
        b, mb, _, hkv, t, d = blocks.shape
        return tuple(blocks[:, :, j].transpose(1, 2).reshape(
            b, hkv, mb * t, d).contiguous() for j in (0, 1))

    cases = {"path: bf16, 16 KV heads of 64, T 32, seq 61-80":
             case(16, 1, 64, False),
             "MQA: int8, 1 KV head x 16, D 128, T 32, seq 61-80":
             case(1, 16, 128, True)}
    timings = {}
    for what, (pool, q, table, seq, kw) in cases.items():
        out = call(da.fused_paged_decode_attention, pool, L - 1, q, table,
                   seq, kw)
        ref = call(da.plain_paged_decode_attention, pool, L - 1, q, table,
                   seq, kw)
        f32 = (lambda t: t) if pool.dtype == torch.int8 else (
            lambda t: t.float())
        ref32 = call(da.plain_paged_decode_attention, f32(pool), L - 1,
                     q.float(), table, seq, kw)
        torch.cuda.synchronize()
        e16, e32 = rel_err(out, ref), rel_err(out, ref32)
        print(f"paged decode ({what}): rel err vs plain bf16 {e16:.3e}, vs "
              f"fp32 {e32:.3e}")
        check(bool(torch.isfinite(out).all()) and e16 < 2e-2 and e32 < 1e-2,
              f"paged decode attention ({what}) matches plain (rel 2e-2 "
              "bf16, 1e-2 fp32)")
        # timed rotating over the 24 layers (100 MB of bf16 pool, past the
        # 50 MB L2); the plain version and the gather launch some 30
        # kernels a call, so 10 calls of them fit in the launch queue
        ms, wall = time_ms(torch, lambda i: call(
            da.fused_paged_decode_attention, pool, i % L, q, table, seq, kw))
        plain_ms, _ = time_ms(torch, lambda i: call(
            da.plain_paged_decode_attention, pool, i % L, q, table, seq, kw),
            iters=10)
        gather_ms, _ = time_ms(torch, lambda i: gathered(pool, i % L, table,
                                                         kw), iters=10)
        k_g, v_g = (torch.stack(t) for t in zip(*(
            gathered(pool, i, table, kw) for i in range(L))))
        mask = (torch.arange(MB * T, device=dev)[None, :]
                < seq[:, None])[:, None, None, :]
        gqa = q.shape[1] != pool.shape[3]
        lib_ms, _ = time_ms(torch, lambda i: sdpa(
            q, k_g[i % L], v_g[i % L], attn_mask=mask, scale=kw["scale"],
            enable_gqa=gqa))
        lib_err = rel_err(sdpa(q, k_g[L - 1], v_g[L - 1], attn_mask=mask,
                               scale=kw["scale"], enable_gqa=gqa), out)
        del k_g, v_g
        # bytes: K and V of the valid tokens (the pool is token-major, so a
        # partial block's tail need not be read), q, the output, the table
        # and the lengths; operations: 4 per (query head, valid key, d)
        hkv, d, h = pool.shape[3], pool.shape[5], q.shape[1]
        n_bytes = (int(seq.sum()) * 2 * hkv * d * pool.element_size()
                   + 2 * B * h * d * 2 + B * MB * 4 + B * 4)
        b_ms, b_by = bound(n_bytes, 4 * h * d * int(seq.sum()),
                           PEAK_FP32_CUDA_CORES)
        # the plan the wrapper passes to the kernel
        plan = da.paged_plan(MB, T, h // hkv)
        print(f"paged decode ({what}): plan {plan}")
        print(f"paged decode ({what}): {ms * 1e3:.2f} us (bound "
              f"{b_ms * 1e3:.3f} us, {b_by}, {n_bytes / 1e6:.3f} MB); plain "
              f"{plain_ms * 1e3:.2f} us; SDPA on the gathered K/V "
              f"{lib_ms * 1e3:.2f} us (rel err vs the kernel {lib_err:.3e}) "
              f"+ the gather {gather_ms * 1e3:.2f} us")
        timings[what] = dict(
            max_abs_err=float((out.float() - ref32).abs().max()), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library_gather_ms=gather_ms, host_call_ms=wall,
            plan=plan, rel_err_vs_plain=(e16, e32))
    path, mqa = (timings[k] for k in cases)
    results["paged_decode_attention"] = dict(
        **path, mqa_int8={k: mqa[k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "library_gather_ms",
            "plan", "rel_err_vs_plain")})


# the window phase's rows: prompt chunks at these offsets (a 60-token prompt
# in chunks of 16, the last one 15 tokens), then decode windows
WINDOW_CHUNK_OFFSETS = (0, 16, 37, 45)
WINDOW_WIDTH = 16


def window_cases(torch, gen, dev, L, N, hkv, rep, d, int8):
    """(pool, q, table, seq, offset, kwargs) of one window call at the
    serve path's rows: rows 0-3 prompt chunks of a SERVE_PROMPT-token
    prompt at WINDOW_CHUNK_OFFSETS (seq the offset plus the chunk's
    tokens), rows 4-7 decode windows (one real token at seq - 1, seq in
    61-80); each row's blocks a permuted draw, -1 past its seq."""
    T, B, MB, W = SERVE_BLOCK, SERVE_SLOTS, SERVE_MAX_SEQ // SERVE_BLOCK, \
        WINDOW_WIDTH
    shape = (L, N, 2, hkv, T, d)
    pool = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8) if int8 else
            torch.randn(shape, generator=gen, device=dev).bfloat16())
    q = torch.randn((B, hkv * rep, W, d), generator=gen,
                    device=dev).bfloat16()
    off = list(WINDOW_CHUNK_OFFSETS)
    seq = [min(o + W, SERVE_PROMPT) for o in off]
    dec = torch.randint(SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_NEW + 1,
                        (B - len(off),), generator=gen, device=dev).tolist()
    seq += dec
    off += [n - 1 for n in dec]
    seq = torch.tensor(seq, dtype=torch.int32, device=dev)
    off = torch.tensor(off, dtype=torch.int32, device=dev)
    table = torch.randperm(N, generator=gen, device=dev).to(
        torch.int32)[:B * MB].reshape(B, MB)
    need = (seq + T - 1) // T
    table = torch.where(torch.arange(MB, device=dev)[None, :]
                        < need[:, None], table, -1)
    kw = dict(scale=d ** -0.5, kv_quant_orig_scale=(
        torch.tensor(1 / 40.0, device=dev) if int8 else None))
    return pool, q, table, seq, off, kw


def window_phase(torch, results, gen):
    """The paged kernel's window entry against its plain version at the
    serve path's shape (8 rows, a pool of 24 layers x 32 blocks of 32
    tokens, 16 KV heads of 64, tables of 4 blocks, windows of 16: prompt
    chunks at offsets 0, 16, 37, 45 beside decode windows), with a bf16
    pool, an int8 pool and one KV head under 16 query heads of 128 (MQA,
    bf16); each timed against its plain version and SDPA with an explicit
    mask on K/V gathered through the table beforehand (the gather timed on
    its own)."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    L, N, T, B, MB = 24, 32, SERVE_BLOCK, SERVE_SLOTS, SERVE_MAX_SEQ // \
        SERVE_BLOCK
    W = WINDOW_WIDTH
    cases = {"path: bf16, 16 KV heads of 64": (16, 1, 64, False),
             "int8 pool, 16 KV heads of 64": (16, 1, 64, True),
             "MQA: bf16, 1 KV head x 16, D 128": (1, 16, 128, False)}

    def call(impl, pool, layer, q, table, seq, off, kw):
        return impl(pool, layer, q, table, seq, off, kw["scale"],
                    kv_quant_orig_scale=kw["kv_quant_orig_scale"])

    def gathered(pool, layer, table, kw):
        """one layer's K and V through the table, [B, Hkv, MB*T, D] bf16"""
        blocks = pool[layer][table.long().clamp(min=0)]   # [B,MB,2,Hkv,T,D]
        if pool.dtype == torch.int8:
            blocks = (blocks.float() * kw["kv_quant_orig_scale"]).bfloat16()
        b, mb, _, hkv, t, d = blocks.shape
        return tuple(blocks[:, :, j].transpose(1, 2).reshape(
            b, hkv, mb * t, d).contiguous() for j in (0, 1))

    timings = {}
    for what, shape in cases.items():
        pool, q, table, seq, off, kw = window_cases(torch, gen, dev, L, N,
                                                    *shape)
        before = da.launches["paged_window_attention"]
        out = call(da.fused_paged_window_attention, pool, L - 1, q, table,
                   seq, off, kw)
        check(da.launches["paged_window_attention"] == before + 1,
              f"paged window ({what}): one launch a call")
        ref = call(da.plain_paged_window_attention, pool, L - 1, q, table,
                   seq, off, kw)
        f32 = (lambda t: t) if pool.dtype == torch.int8 else (
            lambda t: t.float())
        ref32 = call(da.plain_paged_window_attention, f32(pool), L - 1,
                     q.float(), table, seq, off, kw)
        torch.cuda.synchronize()
        e16, e32 = rel_err(out, ref), rel_err(out, ref32)
        print(f"paged window ({what}): rel err vs plain bf16 {e16:.3e}, vs "
              f"fp32 {e32:.3e}")
        check(bool(torch.isfinite(out).all()) and e16 < 2e-2 and e32 < 1e-2,
              f"paged window attention ({what}) matches plain (rel 2e-2 "
              "bf16, 1e-2 fp32)")
        ms, wall = time_ms(torch, lambda i: call(
            da.fused_paged_window_attention, pool, i % L, q, table, seq, off,
            kw))
        plain_ms, _ = time_ms(torch, lambda i: call(
            da.plain_paged_window_attention, pool, i % L, q, table, seq,
            off, kw), iters=10)
        gather_ms, _ = time_ms(torch, lambda i: gathered(pool, i % L, table,
                                                         kw), iters=10)
        k_g, v_g = (torch.stack(t) for t in zip(*(
            gathered(pool, i, table, kw) for i in range(L))))
        kpos = torch.arange(MB * T, device=dev)[None, None, :]
        qpos = torch.arange(W, device=dev)[None, :, None]
        mask = ((kpos < seq[:, None, None])
                & (kpos <= off[:, None, None] + qpos))[:, None]
        gqa = q.shape[1] != pool.shape[3]
        lib_ms, _ = time_ms(torch, lambda i: sdpa(
            q, k_g[i % L], v_g[i % L], attn_mask=mask, scale=kw["scale"],
            enable_gqa=gqa))
        lib_err = rel_err(sdpa(q, k_g[L - 1], v_g[L - 1], attn_mask=mask,
                               scale=kw["scale"], enable_gqa=gqa), out)
        del k_g, v_g
        # bytes: K and V of the valid tokens, q, the output, the table, the
        # lengths and the offsets; operations: 4 per (query row, head, key
        # it attends, d)
        hkv, d, h = pool.shape[3], pool.shape[5], q.shape[1]
        keys = torch.minimum(seq[:, None], off[:, None] + 1 + torch.arange(
            W, device=dev)[None, :])
        n_bytes = (int(seq.sum()) * 2 * hkv * d * pool.element_size()
                   + 2 * B * h * W * d * 2 + B * MB * 4 + 2 * B * 4)
        b_ms, b_by = bound(n_bytes, 4 * h * d * int(keys.sum()),
                           PEAK_FP32_CUDA_CORES)
        print(f"paged window ({what}): {ms * 1e3:.2f} us (bound "
              f"{b_ms * 1e3:.3f} us, {b_by}, {n_bytes / 1e6:.3f} MB); plain "
              f"{plain_ms * 1e3:.2f} us; SDPA with the mask on the gathered "
              f"K/V {lib_ms * 1e3:.2f} us (rel err vs the kernel "
              f"{lib_err:.3e}) + the gather {gather_ms * 1e3:.2f} us")
        timings[what] = dict(
            max_abs_err=float((out.float() - ref32).abs().max()), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library_gather_ms=gather_ms, host_call_ms=wall,
            rel_err_vs_plain=(e16, e32))
    path, int8, mqa = (timings[k] for k in cases)
    keep = ("ms", "plain_ms", "bound_ms", "library_ms", "library_gather_ms",
            "rel_err_vs_plain")
    results["paged_window_attention"] = dict(
        **path, int8={k: int8[k] for k in keep},
        mqa={k: mqa[k] for k in keep})


def serve_beam_case(torch, gen, dev, L, n_blocks, int8):
    """One step of the paged_beam cell: SERVE_SLOTS slots of SERVE_BEAM
    beams over a pool of ``L`` layers x ``n_blocks`` blocks of SERVE_BLOCK
    tokens, 16 heads of 64 (bf16, or int8 with a scale): each slot's
    SERVE_PROMPT-token prompt in one full block shared by its beams and a
    partial block copied into each beam's own, a private generation block
    a beam once its length passes 64, the rest of the table -1; lengths
    61-80 a slot; the indirection maps the prompt to the slot's first row
    and each later position to a random beam.  Returns (pool, q, table,
    seq, ind, kwargs)."""
    G, W, T, H, D = SERVE_SLOTS, SERVE_BEAM, SERVE_BLOCK, 16, 64
    MB = SERVE_MAX_SEQ // T
    shape = (L, n_blocks, 2, H, T, D)
    pool = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8) if int8 else
            torch.randn(shape, generator=gen, device=dev).bfloat16())
    q = torch.randn((G * W, H, 1, D), generator=gen, device=dev).bfloat16()
    n = torch.randint(SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_NEW + 1, (G,),
                      generator=gen, device=dev, dtype=torch.int32)
    blocks = torch.randperm(n_blocks, generator=gen, device=dev).to(
        torch.int32).tolist()
    table = torch.full((G * W, MB), -1, dtype=torch.int32, device=dev)
    for g in range(G):
        shared = blocks.pop()
        for w in range(W):
            row = [shared] + [blocks.pop() for _ in range(
                -(-int(n[g]) // T) - 1)]
            table[g * W + w, :len(row)] = torch.tensor(row, device=dev)
    seq = n.repeat_interleave(W)
    ind = torch.randint(0, W, (G, W, SERVE_MAX_SEQ), generator=gen,
                        device=dev, dtype=torch.int32)
    ind[..., :SERVE_PROMPT] = 0
    kw = dict(scale=D ** -0.5, kv_quant_orig_scale=(
        torch.tensor(1 / 40.0, device=dev) if int8 else None))
    return pool, q, table, seq, ind, kw


def paged_pairs(torch, table, seq, ind, T):
    """The distinct (block, token) pairs that the beam rows' tables and
    the indirection ``ind`` [groups, beams, S] point at below each row's
    length: the K/V that a paged beam step must read."""
    G, W, S = ind.shape
    pos = torch.arange(S, device=ind.device)
    src = (torch.arange(G, device=ind.device)[:, None, None] * W
           + ind.long())                                   # [G, W, S]
    blk = table.long()[src.reshape(-1, S), (pos // T)[None, :].expand(
        G * W, S)]
    valid = pos[None, :] < seq.long()[:, None]
    pair = blk * T + (pos % T)[None, :]
    return int(torch.unique(pair[valid]).numel())


def paged_beam_phase(torch, results):
    """The paged kernel's beam entry against its plain version at the
    paged_beam cell's shape (32 rows: 8 slots of 4 beams; 16 heads of 64;
    blocks of 32; :func:`serve_beam_case`), bf16 and int8 pools over 24
    layers; each timed with CUDA events behind a spin, with its plain
    version's time and SDPA with the length mask on K/V gathered through
    the table and the indirection beforehand (the gather timed on its
    own).  Its own generator keeps the other phases' draws as they
    were."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    L, T, MB = 24, SERVE_BLOCK, SERVE_MAX_SEQ // SERVE_BLOCK
    n_blocks = SERVE_SLOTS * (1 + SERVE_BEAM * (MB - 1))

    def call(impl, pool, layer, q, table, seq, ind, kw):
        return impl(pool, layer, q, table, seq, ind, kw["scale"],
                    kv_quant_orig_scale=kw["kv_quant_orig_scale"])

    def gathered(pool, layer, table, ind, kw):
        """one layer's K and V of each row through its table and the
        indirection, [rows, H, MB*T, D] bf16"""
        G, W, S = ind.shape
        rows = G * W
        src = (torch.arange(G, device=dev)[:, None, None] * W
               + ind.long()).reshape(rows, S)
        pos = torch.arange(S, device=dev)[None, :].expand(rows, S)
        blk = table.long()[src, pos // T].clamp(min=0)     # [rows, S]
        kv = pool[layer][blk, :, :, pos % T]               # [rows,S,2,H,D]
        if pool.dtype == torch.int8:
            kv = (kv.float() * kw["kv_quant_orig_scale"]).bfloat16()
        return tuple(kv[:, :, j].transpose(1, 2).contiguous()
                     for j in (0, 1))

    timings = {}
    for what, int8 in (("path: bf16", False), ("int8 pool", True)):
        pool, q, table, seq, ind, kw = serve_beam_case(torch, gen, dev, L,
                                                       n_blocks, int8)
        before = da.launches["paged_beam_attention"]
        out = call(da.fused_paged_beam_attention, pool, L - 1, q, table,
                   seq, ind, kw)
        check(da.launches["paged_beam_attention"] == before + 1,
              f"paged beam ({what}): one launch a call")
        ref = call(da.plain_paged_beam_attention, pool, L - 1, q, table,
                   seq, ind, kw)
        f32 = (lambda t: t) if int8 else (lambda t: t.float())
        ref32 = call(da.plain_paged_beam_attention, f32(pool), L - 1,
                     q.float(), table, seq, ind, kw)
        torch.cuda.synchronize()
        e16, e32 = rel_err(out, ref), rel_err(out, ref32)
        print(f"paged beam ({what}): rel err vs plain bf16 {e16:.3e}, vs "
              f"fp32 {e32:.3e}")
        check(bool(torch.isfinite(out).all()) and e16 < 2e-2 and e32 < 1e-2,
              f"paged beam attention ({what}) matches plain (rel 2e-2 bf16, "
              "1e-2 fp32)")
        ms, wall = time_ms(torch, lambda i: call(
            da.fused_paged_beam_attention, pool, i % L, q, table, seq, ind,
            kw))
        plain_ms, _ = time_ms(torch, lambda i: call(
            da.plain_paged_beam_attention, pool, i % L, q, table, seq, ind,
            kw), iters=10)
        gather_ms, _ = time_ms(torch, lambda i: gathered(
            pool, i % L, table, ind, kw), iters=10)
        k_g, v_g = (torch.stack(t) for t in zip(*(
            gathered(pool, i, table, ind, kw) for i in range(L))))
        mask = (torch.arange(SERVE_MAX_SEQ, device=dev)[None, :]
                < seq[:, None])[:, None, None, :]
        lib_ms, _ = time_ms(torch, lambda i: sdpa(
            q, k_g[i % L], v_g[i % L], attn_mask=mask, scale=kw["scale"]))
        lib_err = rel_err(sdpa(q, k_g[L - 1], v_g[L - 1], attn_mask=mask,
                               scale=kw["scale"]), out)
        del k_g, v_g
        # bytes: K and V of the distinct (block, token) pairs the tables
        # and the indirection point at, q, the output, the tables, the
        # indirection's valid positions and the lengths; operations: 4 per
        # (row, head, valid key, d)
        rows, H, D = q.shape[0], q.shape[1], q.shape[3]
        pairs = paged_pairs(torch, table, seq, ind, T)
        n_bytes = (pairs * 2 * H * D * pool.element_size()
                   + 2 * rows * H * D * 2 + rows * MB * 4
                   + int(seq.sum()) * 4 + rows * 4)
        b_ms, b_by = bound(n_bytes, 4 * H * D * int(seq.sum()),
                           PEAK_FP32_CUDA_CORES)
        plan = da.paged_plan(MB, T, 1)
        print(f"paged beam ({what}): plan {plan}; the tables and the "
              f"indirection point at {pairs} of {int(seq.sum())} (row, "
              f"token) reads")
        print(f"paged beam ({what}): {ms * 1e3:.2f} us (bound "
              f"{b_ms * 1e3:.3f} us, {b_by}, {n_bytes / 1e6:.3f} MB); plain "
              f"{plain_ms * 1e3:.2f} us; SDPA with the mask on the gathered "
              f"K/V {lib_ms * 1e3:.2f} us (rel err vs the kernel "
              f"{lib_err:.3e}) + the gather {gather_ms * 1e3:.2f} us")
        timings[what] = dict(
            max_abs_err=float((out.float() - ref32).abs().max()), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library_gather_ms=gather_ms, host_call_ms=wall,
            plan=plan, table_pairs=pairs, rel_err_vs_plain=(e16, e32))
        del pool
    path, int8 = timings.values()
    results["paged_beam_attention"] = dict(
        **path, int8={k: int8[k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "library_gather_ms",
            "rel_err_vs_plain", "max_abs_err")})


def serve_beam_kernel_phase(torch, results):
    """Kernel 1's beam entry at the dense_beam cell's shape (GPT-350M: 24
    layers of 16 heads of 64, bf16; 8 slots of 4 beams, a slot cache of
    SERVE_MAX_SEQ columns, sequence 70: the middle of a request's 20
    steps; the prompt read from each slot's first row, later positions
    from random beams) against its plain version, timed with its bound,
    the plain version's time and the library's (:func:`beam_numbers`).
    Its own generator keeps the other phases' draws as they were."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    L, G, W, H, D, S = 24, SERVE_SLOTS, SERVE_BEAM, 16, 64, SERVE_MAX_SEQ
    n = SERVE_PROMPT + SERVE_NEW // 2
    scale = D ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q = randn(G * W, H, 1, D)
    cache = randn(L, G * W, 2, H, D, S)
    fresh = (randn(G * W, H, D, 1), randn(G * W, H, D, 1))
    ind = torch.randint(0, W, (G, W, S), generator=gen, device=dev,
                        dtype=torch.int32)
    ind[..., :SERVE_PROMPT] = 0
    seq = torch.full((G * W,), n, dtype=torch.int32, device=dev)
    kw = dict(fresh_kv=fresh, beam_indirection=ind)
    out = da.fused_decode_attention(cache, 3, q, seq, scale, **kw)
    ref = da.plain_beam_decode_attention(cache, 3, q, seq, scale, **kw)
    ref32 = da.plain_beam_decode_attention(
        cache[3:4].float(), 0, q.float(), seq, scale,
        fresh_kv=tuple(t.float() for t in fresh), beam_indirection=ind)
    torch.cuda.synchronize()
    e16, e32 = rel_err(out, ref), rel_err(out, ref32)
    print(f"beam decode (dense_beam shape): rel err vs plain bf16 "
          f"{e16:.3e}, vs fp32 {e32:.3e}")
    check(e16 < 2e-2 and e32 < 1e-2,
          f"beam decode attention ({G} groups of beam {W}, {H} heads, S={S}, "
          f"seq {n}) matches plain (rel 2e-2 bf16, 1e-2 fp32)")
    results["beam_decode_attention_serve"] = dict(
        max_abs_err=float((out.float() - ref32).abs().max()),
        rel_err_vs_plain=(e16, e32),
        **beam_numbers(torch, da, cache, q, seq, fresh, ind, n))


# -- the fp8 (e4m3) modes of the attention kernels -----------------------------

def to_e4m3(torch, x, amax):
    """x as e4m3 values at the per-tensor scale amax / 448 (the saturating
    cast of the port's cache writes): (values, dequant scale tensor)."""
    from eddie_wang_hackathon2023_tpu_torch.ops.attention import (
        FP8, quantize_cache_values)
    s = torch.tensor([amax / 448.0], device=x.device)
    return quantize_cache_values(x, FP8, 1.0 / s), s


def nan_past(torch, cache, cols):
    """A seq-minor e4m3 cache [L, B, 2, H, D, S] with each row b's
    columns at and past ``cols[b]`` set to the NaN byte 0x7F, in place:
    no kernel may read them into a result."""
    pos = torch.arange(cache.shape[-1], device=cache.device)
    mask = pos[None, :] >= cols.reshape(-1, 1).to(pos.device)
    cache.view(torch.uint8).masked_fill_(
        mask[None, :, None, None, None, :], 0x7F)
    return cache


def nan_slots(torch, pool, table, seq):
    """A token-major e4m3 pool [L, N, 2, Hkv, T, D] with every token slot
    that no row's length covers through its table set to the NaN byte,
    in place."""
    N, T = pool.shape[1], pool.shape[4]
    MB = table.shape[1]
    pos = torch.arange(MB * T, device=pool.device)
    blk = table.long()[:, pos // T]                        # [B, MB * T]
    live = (pos[None, :] < seq.long()[:, None]) & (blk >= 0)
    covered = torch.zeros((N, T), dtype=torch.bool, device=pool.device)
    covered[blk[live], (pos % T)[None, :].expand_as(blk)[live]] = True
    pool.view(torch.uint8).masked_fill_(
        ~covered[None, :, None, None, :, None], 0x7F)
    return pool


def within_gate(torch, errs, fresh, n_layer, tol):
    """Whether a megakernel step's (hidden, fresh K/V) relative errors
    ``errs`` against its plain version pass at ``n_layer`` layers: both
    under ``tol``.  Over an e4m3 self cache past one layer, the layers'
    bf16 drift moves a value across an e4m3 rounding boundary: the fresh
    K/V under tol plus one step at the top of the range (32 of 448; an
    e4m3 step is 1/8 of a value where int8's is 1/127 of the largest),
    and the hidden state, which such flips feed, under 2 tol."""
    if fresh.dtype != torch.float8_e4m3fn or n_layer == 1:
        return max(errs) < tol
    return errs[0] < 2 * tol and errs[1] < tol + 32 / 448


def e4m3_row(torch, results, row, what, call, plain, plain32, lib, n_bytes,
             flops, peak, extra=None, plain_iters=10):
    """One e4m3 row: the kernel (``call(i)``, layer i rotating) against
    its plain version in bf16 and fp32 (``plain(i)``, ``plain32(i)``) at
    layer 0, the output finite (the unused columns hold NaN bytes), then
    the kernel, the plain version and the library call ``lib(i)`` (or
    None) timed; the bound from the bytes and operations given."""
    out, ref, ref32 = call(0), plain(0), plain32(0)
    torch.cuda.synchronize()
    e16, e32 = rel_err(out, ref), rel_err(out, ref32)
    print(f"{what}: rel err vs plain bf16 {e16:.3e}, vs fp32 {e32:.3e}")
    check(bool(torch.isfinite(out).all()) and e16 < 2e-2 and e32 < 1e-2,
          f"{what}: finite over NaN bytes past the lengths, matches plain "
          "(rel 2e-2 bf16, 1e-2 fp32)")
    ms, wall = time_ms(torch, call)
    plain_ms, _ = time_ms(torch, plain, iters=plain_iters)
    lib_ms = None if lib is None else time_ms(torch, lib)[0]
    b_ms, b_by = bound(n_bytes, flops, peak)
    print(f"{what}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us, {b_by}, "
          f"{n_bytes / 1e6:.3f} MB); plain {plain_ms * 1e3:.2f} us; library "
          + ("none" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"))
    results[row] = dict(
        max_abs_err=float((out.float() - ref32.float()).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        host_call_ms=wall, rel_err_vs_plain=(e16, e32), **(extra or {}))
    return out


def fp8_kernel_phase(torch, results):
    """The e4m3 modes of the attention kernels at their paths' shapes, each
    over an e4m3 cache or pool whose unused columns or slots hold the NaN
    byte 0x7F, against its plain version (bf16 and fp32), timed beside it
    and, as the int8 rows, SDPA on K/V dequantised to bf16 beforehand
    (gathered through the table for the paged and beam entries); the
    bounds count the bytes as int8's.  Kernel 1: the fp8_scanned path's
    self call (Whisper large-v2, 20 heads of 64, a cache of 448 at
    sequence 44, the fresh K/V; also held bit-equal to its step-by-step
    version, as the bf16 and int8 modes are); its beam entry at the
    dense_fp8_beam cell's shape; the grouped kernel at the decoder_fp8
    path's (SantaCoder-1B, 16 query heads over one KV head of 128, 8 rows
    at sequence 70 from start 4); the paged kernel's three entries at the
    serve cells' (8 rows, 16 KV heads of 64, blocks of 32).  Its own
    generator keeps the other phases' draws as they were."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def bf16(x, s):
        return (x.float() * s).bfloat16()

    # kernel 1, the self call over an e4m3 cache
    L, H, D, S, n = 32, 20, 64, 448, 44
    scale = D ** -0.5
    cache, ks = to_e4m3(torch, randn(L, 1, 2, H, D, S), 4.0)
    fresh = tuple(to_e4m3(torch, randn(1, H, D, 1), 4.0)[0]
                  for _ in range(2))
    nan_past(torch, cache, torch.tensor([n - 1]))
    q = randn(1, H, 1, D).bfloat16()
    seq = torch.full((1,), n, dtype=torch.int32, device=dev)
    kw = dict(kv_quant_orig_scale=ks, fresh_kv=fresh)
    k_sd, v_sd = (torch.cat([bf16(cache[:, :, j, :, :, :n - 1], ks),
                             bf16(fresh[j], ks)[None].expand(L, -1, -1, -1,
                                                             -1)],
                            dim=-1).transpose(-1, -2).contiguous()
                  for j in (0, 1))
    out = e4m3_row(
        torch, results, "decode_attention_e4m3_self",
        f"decode attention (e4m3 self, S={S}, seq {n}, fresh)",
        lambda i: da.fused_decode_attention(cache, i % L, q, seq, scale,
                                            **kw),
        lambda i: da.plain_decode_attention(cache, i % L, q, seq, scale,
                                            **kw),
        lambda i: da.plain_decode_attention(cache, i % L, q.float(), seq,
                                            scale, **kw),
        lambda i: sdpa(q, k_sd[i % L], v_sd[i % L], scale=scale),
        2 * H * D * (n - 1) + 2 * H * D + 2 * 2 * H * D + 8, 4 * H * D * n,
        PEAK_FP32_CUDA_CORES, extra=split_of(da, S))
    del k_sd, v_sd
    split = da.plain_split_decode_attention(
        cache, 0, q, seq, scale, splits=da.decode_splits(S), **kw)
    check(torch.equal(out, split), "kernel 1 over e4m3 equals its "
          "step-by-step version (plain_split_decode_attention) bit for bit")
    del cache

    # the beam entry at the dense_fp8_beam cell's shape
    Lb, G, W, Hb, Db, Sb = 24, SERVE_SLOTS, SERVE_BEAM, 16, 64, SERVE_MAX_SEQ
    nb = SERVE_PROMPT + SERVE_NEW // 2
    bcache, bks = to_e4m3(torch, randn(Lb, G * W, 2, Hb, Db, Sb), 4.0)
    nan_past(torch, bcache, torch.full((G * W,), nb - 1))
    bfresh = tuple(to_e4m3(torch, randn(G * W, Hb, Db, 1), 4.0)[0]
                   for _ in range(2))
    bq = randn(G * W, Hb, 1, Db).bfloat16()
    ind = torch.randint(0, W, (G, W, Sb), generator=gen, device=dev,
                        dtype=torch.int32)
    ind[..., :SERVE_PROMPT] = 0
    bseq = torch.full((G * W,), nb, dtype=torch.int32, device=dev)
    bkw = dict(kv_quant_orig_scale=bks, fresh_kv=bfresh,
               beam_indirection=ind)
    bout = da.fused_decode_attention(bcache, 3, bq, bseq, Db ** -0.5, **bkw)
    bref = da.plain_beam_decode_attention(bcache, 3, bq, bseq, Db ** -0.5,
                                          **bkw)
    bref32 = da.plain_beam_decode_attention(bcache, 3, bq.float(), bseq,
                                            Db ** -0.5, **bkw)
    torch.cuda.synchronize()
    e16, e32 = rel_err(bout, bref), rel_err(bout, bref32)
    print(f"beam decode (e4m3, dense_fp8_beam shape): rel err vs plain bf16 "
          f"{e16:.3e}, vs fp32 {e32:.3e}")
    check(bool(torch.isfinite(bout).all()) and e16 < 2e-2 and e32 < 1e-2,
          "beam decode attention over e4m3 (NaN bytes past the lengths) "
          "matches plain (rel 2e-2 bf16, 1e-2 fp32)")
    results["beam_decode_attention_e4m3"] = dict(
        max_abs_err=float((bout.float() - bref32).abs().max()),
        rel_err_vs_plain=(e16, e32),
        **beam_numbers(torch, da, bcache, bq, bseq, bfresh, ind, nb,
                       kscale=bks))
    del bcache

    # the grouped kernel at the decoder_fp8 path's shape
    Lg, B, Hkv, rep, Dg = KV8_DEC_DEPTH, DEC_BATCH, 1, 16, 128
    Sg, ng, st = 64 + DEC_NEW, 70, 4
    gcache, gks = to_e4m3(torch, randn(Lg, B, 2, Hkv, Dg, Sg), 4.0)
    nan_past(torch, gcache, torch.full((B,), ng - 1))
    gfresh = tuple(to_e4m3(torch, randn(B, Hkv, Dg, 1), 4.0)[0]
                   for _ in range(2))
    gq = randn(B, Hkv * rep, 1, Dg).bfloat16()
    gseq = torch.full((B,), ng, dtype=torch.int32, device=dev)
    gstart = torch.full((B,), st, dtype=torch.int32, device=dev)
    gkw = dict(kv_quant_orig_scale=gks, fresh_kv=gfresh, start_index=gstart)
    gk, gv = (torch.stack([torch.cat([
        bf16(gcache[i, :, j, :, :, :ng - 1], gks), bf16(gfresh[j], gks)],
        dim=-1).transpose(-1, -2).contiguous() for i in range(Lg)])
        for j in (0, 1))
    mask = (torch.arange(ng, device=dev)[None, :] >= gstart[:, None])[
        :, None, None, :]
    valid = ng - 1 - st
    e4m3_row(
        torch, results, "gqa_decode_attention_e4m3",
        f"grouped decode (e4m3, {Hkv} KV head x {rep}, D {Dg}, S {Sg}, seq "
        f"{ng}, start {st})",
        lambda i: da.fused_decode_attention(gcache, i % Lg, gq, gseq,
                                            Dg ** -0.5, **gkw),
        lambda i: da.plain_gqa_decode_attention(gcache, i % Lg, gq, gseq,
                                                Dg ** -0.5, **gkw),
        lambda i: da.plain_gqa_decode_attention(gcache, i % Lg, gq.float(),
                                                gseq, Dg ** -0.5, **gkw),
        lambda i: sdpa(gq, gk[i % Lg], gv[i % Lg], attn_mask=mask,
                       scale=Dg ** -0.5, enable_gqa=True),
        2 * B * Hkv * Dg * valid + 2 * B * Hkv * Dg
        + B * Hkv * rep * Dg * 2 * 2 + 2 * B * 4 + 4,
        4 * B * Hkv * rep * Dg * (valid + 1), PEAK_BF16_TENSOR,
        extra=dict(splits=da.gqa_splits(Sg),
                   slice=da.gqa_slice_width(Sg, da.gqa_splits(Sg))))
    del gcache, gk, gv

    # the paged kernel's entries at the serve cells' shapes
    Lp, N, T, MB, Hp, Dp = 24, 32, SERVE_BLOCK, SERVE_MAX_SEQ // \
        SERVE_BLOCK, 16, 64
    pool, pks = to_e4m3(torch, randn(Lp, N, 2, Hp, T, Dp), 4.0)
    pq = randn(SERVE_SLOTS, Hp, 1, Dp).bfloat16()
    pseq = torch.randint(SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_NEW + 1,
                         (SERVE_SLOTS,), generator=gen, device=dev,
                         dtype=torch.int32)
    table = torch.randperm(N, generator=gen, device=dev).to(
        torch.int32).reshape(SERVE_SLOTS, MB)
    table = torch.where(torch.arange(MB, device=dev)[None, :]
                        < ((pseq + T - 1) // T)[:, None], table, -1)
    nan_slots(torch, pool, table, pseq)

    def gathered(p, layer, tab):
        """one layer's K and V of pool ``p`` through ``tab``, dequantised,
        [B, H, MB T, D] bf16 (e4m3 gathered as its bytes)"""
        u = p.view(torch.uint8)[layer][tab.long().clamp(min=0)]
        blocks = bf16(u.view(p.dtype), pks)
        b, mb, _, h, t, d = blocks.shape
        return tuple(blocks[:, :, j].transpose(1, 2).reshape(
            b, h, mb * t, d).contiguous() for j in (0, 1))

    pk, pv = (torch.stack(t) for t in zip(*(gathered(pool, i, table)
                                             for i in range(Lp))))
    pmask = (torch.arange(MB * T, device=dev)[None, :]
             < pseq[:, None])[:, None, None, :]
    tok = int(pseq.sum())
    e4m3_row(
        torch, results, "paged_decode_attention_e4m3",
        "paged decode (e4m3, 16 KV heads of 64, T 32, seq 61-80)",
        lambda i: da.fused_paged_decode_attention(
            pool, i % Lp, pq, table, pseq, Dp ** -0.5, pks),
        lambda i: da.plain_paged_decode_attention(
            pool, i % Lp, pq, table, pseq, Dp ** -0.5, pks),
        lambda i: da.plain_paged_decode_attention(
            pool, i % Lp, pq.float(), table, pseq, Dp ** -0.5, pks),
        lambda i: sdpa(pq, pk[i % Lp], pv[i % Lp], attn_mask=pmask,
                       scale=Dp ** -0.5),
        tok * 2 * Hp * Dp + 2 * SERVE_SLOTS * Hp * Dp * 2
        + SERVE_SLOTS * MB * 4 + SERVE_SLOTS * 4 + 4,
        4 * Hp * Dp * tok, PEAK_FP32_CUDA_CORES,
        extra=dict(plan=da.paged_plan(MB, T, 1)))
    del pk, pv

    # the window entry: prompt chunks and decode windows (window_cases'
    # rows) over an e4m3 pool of their own (at the same scale)
    del pool
    wpool, wq, wtable, wseq, woff, _ = window_cases(torch, gen, dev, Lp, N,
                                                    Hp, 1, Dp, False)
    pool = nan_slots(torch, to_e4m3(torch, wpool, 4.0)[0], wtable, wseq)
    del wpool
    W = wq.shape[2]
    wk, wv = (torch.stack(t) for t in zip(*(gathered(pool, i, wtable)
                                             for i in range(Lp))))
    key = torch.arange(MB * T, device=dev)
    wmask = ((key[None, None, :] < wseq[:, None, None])
             & (key[None, None, :] <= woff[:, None, None]
                + torch.arange(W, device=dev)[None, :, None]))[:, None]
    wtok = int(wseq.sum())
    e4m3_row(
        torch, results, "paged_window_attention_e4m3",
        f"paged window (e4m3, 16 KV heads of 64, windows of {W})",
        lambda i: da.fused_paged_window_attention(
            pool, i % Lp, wq, wtable, wseq, woff, Dp ** -0.5, pks),
        lambda i: da.plain_paged_window_attention(
            pool, i % Lp, wq, wtable, wseq, woff, Dp ** -0.5, pks),
        lambda i: da.plain_paged_window_attention(
            pool, i % Lp, wq.float(), wtable, wseq, woff, Dp ** -0.5, pks),
        lambda i: sdpa(wq, wk[i % Lp], wv[i % Lp], attn_mask=wmask,
                       scale=Dp ** -0.5),
        wtok * 2 * Hp * Dp + 2 * SERVE_SLOTS * Hp * W * Dp * 2
        + SERVE_SLOTS * (MB + 2) * 4 + 4,
        4 * Hp * Dp * W * wtok, PEAK_BF16_TENSOR)
    del wk, wv, pool

    # the beam entry at the paged_fp8_beam cell's shape
    n_blocks = SERVE_SLOTS * (1 + SERVE_BEAM * (MB - 1))
    bpool, bq2, btable, bseq2, bind, _ = serve_beam_case(torch, gen, dev, Lp,
                                                         n_blocks, False)
    bpool, bpks = to_e4m3(torch, bpool, 4.0)
    nan_slots(torch, bpool, btable, bseq2)
    pool = bpool

    def beam_gathered(layer):
        """each row's K and V, position s from the chain of the beam that
        the indirection names, [B, H, MB T, D]"""
        k_r, v_r = gathered(pool, layer, btable)       # [B, H, MB T, D]
        g, w, s = bind.shape
        src = (torch.arange(g, device=dev)[:, None, None] * w
               + bind.long()).reshape(g * w, s)[:, :MB * T]
        pos = torch.arange(MB * T, device=dev)[None, :]
        return tuple(x[src, :, pos].transpose(1, 2).contiguous()
                     for x in (k_r, v_r))

    bk, bv = (torch.stack(t) for t in zip(*(beam_gathered(i)
                                             for i in range(Lp))))
    bmask = (torch.arange(MB * T, device=dev)[None, :]
             < bseq2[:, None])[:, None, None, :]
    pairs = paged_pairs(torch, btable, bseq2, bind, T)
    e4m3_row(
        torch, results, "paged_beam_attention_e4m3",
        f"paged beam (e4m3, {SERVE_SLOTS} slots of {SERVE_BEAM} beams, 16 "
        "heads of 64)",
        lambda i: da.fused_paged_beam_attention(
            pool, i % Lp, bq2, btable, bseq2, bind, Dp ** -0.5, bpks),
        lambda i: da.plain_paged_beam_attention(
            pool, i % Lp, bq2, btable, bseq2, bind, Dp ** -0.5, bpks),
        lambda i: da.plain_paged_beam_attention(
            pool, i % Lp, bq2.float(), btable, bseq2, bind, Dp ** -0.5,
            bpks),
        lambda i: sdpa(bq2, bk[i % Lp], bv[i % Lp], attn_mask=bmask,
                       scale=Dp ** -0.5),
        pairs * 2 * Hp * Dp + 2 * bq2.shape[0] * Hp * Dp * 2
        + bq2.shape[0] * (MB + 1) * 4 + bind.numel() * 4 + 4,
        4 * Hp * Dp * int(bseq2.sum()), PEAK_FP32_CUDA_CORES,
        extra=dict(pool_pairs=pairs))
    del bk, bv, pool, bpool


# -- phase 3: the main path ---------------------------------------------------

# the four linears of a SantaCoder-1B layer (K x N, groups of 128 rows)
INT4_SHAPES = (("qkv", 2048, 2304), ("dense", 2048, 2048),
               ("fc", 2048, 8192), ("proj", 8192, 2048))
INT4_GROUP = 128


def int4pack_operands(torch, qw, sc):
    """The port's int4 weights ([copies, K/2, N], codes in [-8, 7]) and
    group scales ([copies, G, N] fp32) as ``torch._weight_int4pack_mm``
    takes them: unsigned codes q + 8 (its zero point of 8), [N, K] two a
    byte (the even k in the high nibble) through
    ``torch._convert_weight_to_int4pack``, and [G, N, 2] bf16 scales with
    zeros 0; ([packed], [scales and zeros]), or the note of why the card's
    torch cannot."""
    from eddie_wang_hackathon2023_tpu_torch.ops.quant_matmul import \
        unpack_int4
    packed, sz = [], []
    try:
        for i in range(qw.shape[0]):
            u = (unpack_int4(qw[i]).to(torch.int32) + 8).t().contiguous()
            packed.append(torch._convert_weight_to_int4pack(
                (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8))
            sz.append(torch.stack([sc[i], torch.zeros_like(sc[i])], -1)
                      .to(torch.bfloat16).contiguous())
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return (f"no CUDA kernel in torch {torch.__version__}: "
                f"{str(e).splitlines()[0][:160]}")
    return packed, sz


def int4_phase(torch, results, gen):
    """The int4 dequant matmul against its plain version: the four linears
    of SantaCoder-1B (INT4_SHAPES) at decode (M 8) and at the prefill (M
    512, 8 prompts of bucket 64) in groups of 128; M 1; per-channel scales;
    one group ([1, N] scales: the accumulator takes the scale); N 1280, 1040
    and 1000 (the edges of the kernel's 128-column tiles and of its 16-byte
    loads); K 384 in groups of 128 (the two nibbles of a byte in different
    groups); an fp32 x raises.  The two rounding rules are pinned bit for
    bit with one-hot rows of x (row m of the output is then the dequantised
    weight row, no sum involved), through the decode entry (8 rows; at
    proj's shape K split over a cluster) and the prefill entry (the same 8
    rows above 32 zero rows).  Each path
    shape is timed against its plain version and against ``F.linear`` on the
    weight dequantised beforehand, with the dequantisation's own time (what
    a path that dequantises per call pays)."""
    from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
    from eddie_wang_hackathon2023_tpu_torch.ops.quant_matmul import \
        unpack_int4
    dev = torch.device("cuda")

    def operands(k, n, groups, copies=1):
        """packed weights [copies, K/2, N] (every byte value) and scales:
        [copies, N] for groups 0 (per channel), else [copies, groups, N],
        sized so that an output is of order one"""
        qw = torch.randint(-128, 128, (copies, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
        shape = (copies, n) if groups == 0 else (copies, groups, n)
        sc = (torch.rand(shape, generator=gen, device=dev) + 0.5) / (
            4.6 * k ** 0.5)
        return qw, sc

    def randx(m, k):
        return torch.randn((m, k), generator=gen, device=dev).bfloat16()

    errs = {}

    def case(what, m, k, n, groups):
        qw, sc = (t[0] for t in operands(k, n, groups))
        x = randx(m, k)
        out = iq.quant_matmul_int4(x, qw, sc)
        ref = iq.plain_quant_matmul_int4(x, qw, sc)
        ref32 = iq.plain_quant_matmul_int4(x.float(), qw, sc)
        torch.cuda.synchronize()
        e16, e32 = rel_err(out, ref), rel_err(out, ref32)
        errs[what] = (e16, e32, float((out.float() - ref32).abs().max()))
        print(f"int4 matmul ({what}): rel err vs plain bf16 {e16:.3e}, vs "
              f"fp32 {e32:.3e}")
        check(out.shape == (m, n) and out.dtype == torch.bfloat16
              and bool(torch.isfinite(out).all()) and e16 < 2e-2
              and e32 < 1e-2,
              f"int4 matmul ({what}) matches plain (rel 2e-2 bf16, 1e-2 "
              "fp32)")

    for name, k, n in INT4_SHAPES:
        for m in (DEC_BATCH, DEC_BATCH * 64):
            case(f"{name}: M {m}, K {k}, N {n}, groups of {INT4_GROUP}", m,
                 k, n, k // INT4_GROUP)
    case("M 1, K 2048, N 2048, groups of 128", 1, 2048, 2048, 16)
    case("per channel: M 8, K 2048, N 2048", 8, 2048, 2048, 0)
    case("one group [1, N]: M 8, K 128, N 256", 8, 128, 256, 1)
    case("N 1280: M 20, K 1280, per channel", 20, 1280, 1280, 0)
    case("N 1040: M 8, K 2048, groups of 128", 8, 2048, 1040, 16)
    case("N 1000: M 8, K 256, groups of 128", 8, 256, 1000, 2)
    case("K 384 in groups of 128: M 8, N 256", 8, 384, 256, 3)
    try:
        iq.quant_matmul_int4(randx(8, 256).float(), *(
            t[0] for t in operands(256, 256, 2)))
        raised = False
    except TypeError:
        raised = True
    check(raised, "int4 matmul raises for fp32 x on the card (no fallback)")

    # one-hot pins: x row m is e_{k_m}, so output row m is row k_m of the
    # dequantised weight exactly.  Rows in both halves of K (both nibbles),
    # three groups, and proj's shape, whose K is split over a cluster
    for k, n, rows in ((384, 256, [0, 150, 191, 192, 342, 383, 64, 300]),
                       (8192, 2048, [0, 4095, 4096, 8191, 1000, 5000, 2047,
                                     6143])):
        groups = k // INT4_GROUP
        qw, sc = (t[0] for t in operands(k, n, groups))
        rows_t = torch.tensor(rows, device=dev)
        x = torch.zeros((len(rows), k), device=dev, dtype=torch.bfloat16)
        x[torch.arange(len(rows), device=dev), rows_t] = 1
        q = unpack_int4(qw)[rows_t].float()                    # [8, N]
        s_g = sc[rows_t // INT4_GROUP]                         # [8, N]
        grouped = (q * s_g.bfloat16().float()).bfloat16()
        s_c = sc[0]                                            # [N]
        channel = (q * s_c).bfloat16()
        # the decode entry (8 rows), then the prefill entry (40 rows: the
        # 8 one-hot rows after 32 zero rows)
        for xe, cut in ((x, slice(0, 8)),
                        (torch.cat([torch.zeros_like(x).repeat(4, 1), x]),
                         slice(32, 40))):
            entry = "decode" if xe.shape[0] <= iq.DECODE_MAX_M else "prefill"
            out = iq.quant_matmul_int4(xe, qw, sc)[cut]
            check(torch.equal(out, grouped)
                  and not torch.equal(grouped, (q * s_g).bfloat16()),
                  f"int4 matmul ({entry} entry), K {k} N {n}, groups of "
                  f"{INT4_GROUP}, one-hot x: each weight is bf16(q * "
                  "bf16(scale)), bit for bit (a scale not rounded first "
                  "gives other values)")
            out = iq.quant_matmul_int4(xe, qw, s_c)[cut]
            check(torch.equal(out, channel)
                  and not torch.equal(channel, (q * s_c.bfloat16().float())
                                      .bfloat16()),
                  f"int4 matmul ({entry} entry), K {k} N {n}, per channel, "
                  "one-hot x: bf16(q * scale) with the fp32 scale on the "
                  "accumulator, bit for bit")

    shapes = int4_timings(torch, gen, INT4_SHAPES, (DEC_BATCH,
                                                    DEC_BATCH * 64))
    # the row: one layer's four calls at decode (M 8), summed
    dec = [v for key, v in shapes.items() if key.endswith(f"M{DEC_BATCH}")]
    results["int4_quant_matmul"] = dict(
        max_abs_err=max(e[2] for e in errs.values()),
        ms=sum(v["ms"] for v in dec), plain_ms=sum(v["plain_ms"] for v in dec),
        bound_ms=sum(v["bound_ms"] for v in dec),
        bound_by="/".join(sorted({v["bound_by"] for v in dec})),
        library_ms=sum(v["library_ms"] for v in dec),
        library_dequant_ms=sum(v["library_dequant_ms"] for v in dec),
        library_int4pack_ms=(sum(v["library_int4pack_ms"] for v in dec)
                             if all(v["library_int4pack_ms"] for v in dec)
                             else None),
        library_int4pack=dec[0]["library_int4pack"],
        times_are="the four linears of one layer at decode (M 8), summed",
        shapes=shapes, rel_err_vs_plain={k: v[:2] for k, v in errs.items()})

    # Whisper large-v2's linears in groups of 128 (woq4): each decode step's
    # at M 1, the 3-token prompt prefill's, and the int4 encoder's at M
    # 1536 (1500 frames padded), against the plain version, then timed
    errs.clear()
    for name, k, n in WHISPER_INT4_SHAPES:
        for m in (1, 3, 1536):
            case(f"Whisper {name}: M {m}, K {k}, N {n}, groups of "
                 f"{INT4_GROUP}", m, k, n, k // INT4_GROUP)
    wshapes = int4_timings(torch, gen, WHISPER_INT4_SHAPES, (1, 3, 1536))
    # a decode step's layer: qkv, dense, cross-q, cross-dense (both at
    # dense's shape), fc1 and fc2, at M 1
    step = [wshapes["qkv M1"]] + [wshapes["dense M1"]] * 3 + [
        wshapes["fc1 M1"], wshapes["fc2 M1"]]
    results["int4_quant_matmul_whisper"] = dict(
        max_abs_err=max(e[2] for e in errs.values()),
        **{f: sum(v[f] for v in step) for f in ("ms", "plain_ms",
                                                "bound_ms", "library_ms",
                                                "library_dequant_ms")},
        bound_by="/".join(sorted({v["bound_by"] for v in step})),
        library_int4pack_ms=(sum(v["library_int4pack_ms"] for v in step)
                             if all(v["library_int4pack_ms"] for v in step)
                             else None),
        library_int4pack=step[0]["library_int4pack"],
        encoder_layer_ms=sum(wshapes[f"{n} M1536"]["ms"]
                             for n in ("qkv", "dense", "fc1", "fc2")),
        times_are="the six linears of one decoder layer at a decode step "
                  "(M 1), summed",
        shapes=wshapes, rel_err_vs_plain={k: v[:2] for k, v in errs.items()})


def int4_timings(torch, gen, shape_list, ms_list):
    """The int4 kernel timed at each (name, K, N) of ``shape_list`` (groups
    of INT4_GROUP rows) and each M of ``ms_list`` against its plain
    version, ``F.linear`` on the weight dequantised beforehand (and the
    dequantisation's own time: what a path that dequantises per call pays)
    and ``torch._weight_int4pack_mm``, rotating over copies of the weights
    that together exceed the 50 MB L2, as each layer's weights are read
    once a step: {"<name> M<m>": numbers}."""
    import torch.nn.functional as F

    from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
    from eddie_wang_hackathon2023_tpu_torch.ops.quant_matmul import \
        unpack_int4
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {}
    for name, k, n in shape_list:
        groups = k // INT4_GROUP
        copies = -(-120_000_000 // (k // 2 * n))
        qw = torch.randint(-128, 128, (copies, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
        sc = (torch.rand((copies, groups, n), generator=gen, device=dev)
              + 0.5) / (4.6 * k ** 0.5)

        def deq(i):
            w = unpack_int4(qw[i]).bfloat16().reshape(groups, k // groups, n)
            return (w * sc[i][:, None, :].bfloat16()).reshape(k, n)

        lib_copies = -(-120_000_000 // (k * n * 2))
        w_lin = [deq(i).t() for i in range(lib_copies)]        # [N, K] views
        packs = int4pack_operands(torch, qw, sc)
        for m in ms_list:
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
            ms, wall = time_ms(torch, lambda i: iq.quant_matmul_int4(
                x, qw[i % copies], sc[i % copies]))
            plain_ms, _ = time_ms(torch, lambda i: iq.plain_quant_matmul_int4(
                x, qw[i % copies], sc[i % copies]), iters=10)
            deq_ms, _ = time_ms(torch, lambda i: deq(i % copies), iters=10)
            lib_ms, _ = time_ms(torch, lambda i: F.linear(
                x, w_lin[i % lib_copies]))
            p4_ms, p4_err, p4_note = (None, None, packs) if isinstance(
                packs, str) else packed_library_ms(
                torch, lambda i: torch._weight_int4pack_mm(
                    x, packs[0][i % copies], INT4_GROUP, packs[1][i % copies]),
                iq.plain_quant_matmul_int4(x.float(), qw[0], sc[0]))
            # bytes: the packed weights, the fp32 group scales, x and out;
            # operations: 2 M N K on the tensor cores (bf16 products)
            n_bytes = k // 2 * n + groups * n * 4 + m * k * 2 + m * n * 2
            b_ms, b_by = bound(n_bytes, 2 * m * n * k, PEAK_BF16_TENSOR)
            shapes[f"{name} M{m}"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_dequant_ms=deq_ms, library_int4pack_ms=p4_ms,
                library_int4pack_rel_err=p4_err, library_int4pack=p4_note,
                bound_ms=b_ms, bound_by=b_by,
                bytes=n_bytes, host_call_ms=wall,
                plan=(iq.decode_plan(m, n, k, sms) if m <= iq.DECODE_MAX_M
                      else iq.prefill_plan(m, n, k, sms)))
            print(f"int4 matmul {name} M {m} (K {k}, N {n}, plan "
                  f"{shapes[f'{name} M{m}']['plan']}): {ms * 1e3:.2f} "
                  f"us (bound {b_ms * 1e3:.3f} us, {b_by}, {n_bytes / 1e6:.3f}"
                  f" MB); plain {plain_ms * 1e3:.2f} us; F.linear on the "
                  f"dequantised weight {lib_ms * 1e3:.2f} us + the "
                  f"dequantisation {deq_ms * 1e3:.2f} us; _weight_int4pack_mm "
                  + (f"{p4_ms * 1e3:.2f} us (rel err {p4_err:.3e})" if p4_ms
                     else p4_note))
        del qw, sc, w_lin, packs
    return shapes


def example_kernel():
    """``fmha_cuda``, the user kernel's module of
    ``examples/custom_kernel_torch``, imported from its directory
    (importing it registers its source with the port's builder)."""
    path = os.path.join(HERE, "examples", "custom_kernel_torch")
    if path not in sys.path:
        sys.path.insert(0, path)
    import fmha_cuda
    return fmha_cuda


@contextlib.contextmanager
def custom_mha(fn):
    """``fn`` installed by ``set_custom_mha`` inside the block."""
    from eddie_wang_hackathon2023_tpu_torch.ops.flash_attention import \
        set_custom_mha
    set_custom_mha(fn)
    try:
        yield
    finally:
        set_custom_mha(None)


def custom_phase(torch, results, gen):
    """The user kernel of examples/custom_kernel_torch and the causal mode
    of kernel 2 against their plain versions on the card, at the custom
    path's shapes (and the shapes of the example's own check).  The plain
    versions run in fp32 on the same inputs, so that the comparison
    isolates the kernel: gates 1e-5 of the largest output for fp32 (both
    compute in fp32; kernel 2's fp32 entry, which sums split bf16 products,
    1e-4), 1e-2 for a bf16 output (a few bf16 roundings)."""
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    ck = example_kernel()
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32, bf16 = torch.float32, torch.bfloat16

    def views(b, h, lq, lk, d, dtype, offset=0):
        """q [b,h,lq,d], k, v [b,h,lk,d] as strided views of fused
        [b, L, 3, h, d] projection outputs, as the attention layer hands
        them over; ``offset`` elements more a row, the views starting that
        far in (offset 1 in fp32: rows on 4 bytes, not on 16)."""
        qkv = torch.randn((b, max(lq, lk), 3, h, d + offset), generator=gen,
                          device=dev).to(dtype)[..., offset:]
        q, k, v = (qkv[:, :n, i].transpose(1, 2)
                   for i, n in enumerate((lq, lk, lk)))
        return q, k, v

    def sdpa_ms(q, k, v, mask=None, causal=False, live=None):
        """SDPA's time on contiguous copies of the same inputs: the keys
        cut to ``live``, and the mask as ``is_causal`` (top-left) or a
        boolean ``attn_mask``"""
        live = k.shape[2] if live is None else live
        qc = q.contiguous()
        kc, vc = k[:, :, :live].contiguous(), v[:, :, :live].contiguous()
        ms, _ = time_ms(torch, lambda i: sdpa(qc, kc, vc, attn_mask=mask,
                                              is_causal=causal, scale=scale))
        return ms

    # the user kernel: (what, q and k shapes, kv_valid_len, causal, dtype)
    H, D, L, valid = 20, 64, 1536, 1500
    scale = D ** -0.5
    cases = [
        ("[2,4,256,64] (the example's check)", (2, 4, 256, 256), None,
         False, f32),
        ("[2,4,256,64] causal (the example's check)", (2, 4, 256, 256),
         None, True, f32),
        ("encoder [1,20,1536,64] valid 1500", (1, H, L, L), valid, False,
         bf16),
        ("encoder [1,20,1536,64] valid 1500 (sqenc)", (1, H, L, L), valid,
         False, f32),
        ("prompt prefill [1,20,3,64] causal", (1, H, 3, 3), None, True,
         bf16),
        ("[1,20,4,64] causal", (1, H, 4, 4), None, True, bf16),
        ("top-left causal Lq 128, Lk 256", (1, H, 128, 256), None, True,
         f32),
    ]
    errs = {}
    for what, (b, h, lq, lk), vl, causal, dtype in cases:
        q, k, v = views(b, h, lq, lk, D, dtype)
        before = dict(ck.launches)
        out = ck.custom_flash_mha(q, k, v, causal=causal, scale=scale,
                                  kv_valid_len=vl)
        entry = "custom_fmha_f32" if dtype == f32 else "custom_fmha"
        ref = ck.plain_custom_flash_mha(q.float(), k.float(), v.float(),
                                        causal=causal, scale=scale,
                                        kv_valid_len=vl)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        errs[what] = err
        tol = 1e-5 if dtype == f32 else 1e-2
        print(f"custom fmha {what}, {str(dtype)[6:]}: rel err vs fp32 plain "
              f"{err:.3e}")
        check(out.dtype == dtype and ck.launches[entry] == before[entry] + 1
              and err < tol, f"custom fmha {what} {str(dtype)[6:]}: one "
              f"launch, within {tol:g} of the fp32 plain version")
        if lq != lk:
            br = fa.plain_flash_mha(q.float(), k.float(), v.float(),
                                    causal=True, scale=scale)
            check(rel_err(out, br) > 1e-1, "custom fmha masks top-left: "
                  "it differs from the bottom-right mask at Lq 128, Lk 256")

    def timed(b, h, lq, lk, vl, causal, dtype):
        """The user kernel's row at one shape: its time, the plain
        version's and SDPA's on the same inputs, the plan that the wrapper
        passed to the kernel (its variant), and two bounds.  bound_ms: the
        function's operations, 4 per (row, live key, d), at the peak for its
        operands' type: the bf16 tensor cores for bf16, the fp32 CUDA cores
        for fp32.  route_bound_ms: the tensor cores as the kernels take
        them: for bf16 operands Q.K^T is one bf16 product (exact, fp32
        accumulation) and P.V two (P, fp32, as two bf16 terms); for fp32
        operands both are three tf32 products (3xTF32) at the tf32 peak."""
        q, k, v = views(b, h, lq, lk, D, dtype)
        out = ck.custom_flash_mha(q, k, v, causal=causal, scale=scale,
                                  kv_valid_len=vl)
        ref = ck.plain_custom_flash_mha(q.float(), k.float(), v.float(),
                                        causal=causal, scale=scale,
                                        kv_valid_len=vl)
        err = float((out.float() - ref).abs().max())
        ms, wall = time_ms(torch, lambda i: ck.custom_flash_mha(
            q, k, v, causal=causal, scale=scale, kv_valid_len=vl))
        plain_ms, _ = time_ms(torch, lambda i: ck.plain_custom_flash_mha(
            q, k, v, causal=causal, scale=scale, kv_valid_len=vl), iters=10)
        live = lk if vl is None else min(vl, lk)
        # SDPA's is_causal is top-left, as the user kernel's mask
        lib_ms = sdpa_ms(q, k, v, causal=causal, live=live)
        # (row, live key) pairs: row i of a top-left causal call sees i + 1
        pairs = (sum(min(i + 1, live) for i in range(lq)) if causal
                 else lq * live)
        n_bytes = 2 * b * h * (lq + lk) * D * q.element_size()
        b_ms, b_by = bound(n_bytes, 4 * b * h * pairs * D,
                           PEAK_BF16_TENSOR if dtype == bf16
                           else PEAK_FP32_CUDA_CORES)
        if dtype == bf16:
            r_ms, r_by = bound(n_bytes, 3 * 2 * b * h * pairs * D,
                               PEAK_BF16_TENSOR)
        else:
            r_ms, r_by = bound(n_bytes, 3 * 4 * b * h * pairs * D,
                               PEAK_TF32_TENSOR)
        shape = (f"[{b},{h},{lq},{D}]" + (f" Lk {lk}" if lk != lq else "")
                 + (f" valid {vl}" if vl is not None else "")
                 + (" causal" if causal else "") + f" {str(dtype)[6:]}")
        plan = ck.fmha_plan(lq, dtype)
        print(f"custom fmha {shape}: {ms * 1e3:.2f} us, {plan['variant']} "
              f"variant ({plan['row_blocks']} row blocks of {plan['rows']} "
              f"rows, {plan['warps']} warps) (bound {b_ms * 1e3:.3f} us, "
              f"{b_by}; {r_ms * 1e3:.3f} us by the tensor-core route, "
              f"{r_by}; plain {plain_ms * 1e3:.2f}; SDPA {lib_ms * 1e3:.2f})")
        return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    route_bound_ms=r_ms, route_bound_by=r_by,
                    host_call_ms=wall, plan=plan)

    # each entry's row at the shape the custom path gives it: the bf16
    # entry takes the prompt prefill (the short variant), the fp32 entry
    # the SmoothQuant encoder; the bf16 entry is timed at the encoder's
    # shape too (the tiled variant), beside kernel 2's bf16 entry
    short, tiled = (timed(1, H, 3, 3, None, True, bf16),
                    timed(1, H, L, L, valid, False, bf16))
    check(short["plan"]["variant"] == "short"
          and tiled["plan"]["variant"] == "tiled",
          "custom fmha: the prefill takes the short variant, the encoder's "
          "shape the tiled one")
    results["custom_fmha"] = dict(**short, rel_err_vs_plain=errs,
                                  at_encoder_shape=tiled)
    # the fp32 entry (3xTF32) at its edges, each case with its plan, its
    # time and SDPA fp32's: keys cut inside a 64-key tile, causal, one and
    # 17 query rows, and views whose rows start on 4 bytes but not on 16
    # (4-byte copies); each within 1e-5 of the fp32 plain version
    f32_cases = {}
    for what, (b, h, lq, lk), vl, causal, offset in (
            ("valid 200 of 256", (1, H, 256, 256), 200, False, 0),
            ("causal", (1, H, 256, 256), None, True, 0),
            ("Lq 1", (1, H, 1, 1), None, False, 0),
            ("Lq 17 causal", (1, H, 17, 17), None, True, 0),
            ("4-byte-aligned views, the encoder's shape", (1, H, L, L),
             valid, False, 1)):
        q, k, v = views(b, h, lq, lk, D, f32, offset)
        before = ck.launches["custom_fmha_f32"]
        out = ck.custom_flash_mha(q, k, v, causal=causal, scale=scale,
                                  kv_valid_len=vl)
        ref = ck.plain_custom_flash_mha(q, k, v, causal=causal, scale=scale,
                                        kv_valid_len=vl)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        check(ck.launches["custom_fmha_f32"] == before + 1 and err < 1e-5,
              f"custom fmha fp32 {what} [{b},{h},{lq},{D}]: one launch, "
              "within 1e-5 of the fp32 plain version")
        ms, _ = time_ms(torch, lambda i: ck.custom_flash_mha(
            q, k, v, causal=causal, scale=scale, kv_valid_len=vl))
        lib_ms = sdpa_ms(q, k, v, causal=causal, live=vl)
        plan = ck.fmha_plan(lq, f32)
        print(f"custom fmha fp32 {what} [{b},{h},{lq},{D}]: rel err "
              f"{err:.3e}, {plan['row_blocks']} row blocks of {plan['warps']}"
              f" warps, {ms * 1e3:.2f} us (SDPA {lib_ms * 1e3:.2f})")
        f32_cases[what] = dict(rel_err=err, plan=plan, ms=ms,
                               library_ms=lib_ms)
    results["custom_fmha_f32"] = dict(
        **timed(1, H, L, L, valid, False, f32), rel_err_vs_plain=errs,
        cases=f32_cases)

    # kernel 2, causal (bottom-right, as causal_bias), each case with its
    # plan (the wrapper's causal_plan; the fp32 entry keeps the first
    # design), its time and the library's: SDPA is_causal where Lq == Lk
    # and every key is valid, else the same mask as a boolean attn_mask.
    # Lq at the 64-key tiles' edges and the path's 227, Lq < Lk (the
    # bottom-right offset), valid < Lk, B * H past the 132 SMs
    ferrs, fcases = {}, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, h, lq, lk, vl, dtype in (
            (1, H, 128, 128, None, bf16), (1, H, 129, 129, None, bf16),
            (1, H, 255, 255, None, bf16), (1, H, 256, 256, None, bf16),
            (1, H, 200, 256, None, bf16), (1, H, 256, 256, 200, bf16),
            (8, H, 256, 256, None, bf16), (8, 16, 128, 128, None, bf16),
            (1, H, 256, 256, None, f32), (1, H, 200, 256, 230, f32),
            (1, H, PROMPTED_PREFILL, PROMPTED_PREFILL, None, bf16)):
        q, k, v = views(b, h, lq, lk, D, dtype)
        entry = "flash_attention_causal" + ("_f32" if dtype == f32 else "")
        before = fa.launches[entry]
        out = fa.flash_mha(q, k, v, causal=True, scale=scale,
                           kv_valid_len=vl)
        ref = fa.plain_flash_mha(q.float(), k.float(), v.float(),
                                 causal=True, scale=scale, kv_valid_len=vl)
        torch.cuda.synchronize()
        what = (f"[{b},{h},{lq},{D}]" + (f" Lk {lk}" if lk != lq else "")
                + (f" valid {vl}" if vl is not None else "")
                + f" {str(dtype)[6:]}")
        ferrs[what] = err = rel_err(out, ref)
        tol = 1e-4 if dtype == f32 else 1e-2
        check(fa.launches[entry] == before + 1 and err < tol,
              f"flash attention causal {what}: one launch, within {tol:g} "
              f"of the fp32 plain version (rel err {err:.3e})")
        ms, _ = time_ms(torch, lambda i: fa.flash_mha(
            q, k, v, causal=True, scale=scale, kv_valid_len=vl))
        live = lk if vl is None else vl
        if lq == lk and live == lk:
            lib_ms = sdpa_ms(q, k, v, causal=True)
        else:
            cols = torch.arange(lk, device=dev)
            mask = ((cols[None, :] <= torch.arange(lq, device=dev)[:, None]
                     + lk - lq) & (cols[None, :] < live))
            lib_ms = sdpa_ms(q, k, v, mask=mask)
        plan = (fa.causal_plan(lq, lk, live, b * h, sms) if dtype == bf16
                else "first design: 64 rows a block")
        print(f"flash causal {what}: rel err vs fp32 plain {err:.3e}, plan "
              f"{plan}, {ms * 1e3:.2f} us (SDPA {lib_ms * 1e3:.2f})")
        fcases[what] = dict(rel_err=err, plan=plan, ms=ms, library_ms=lib_ms)
    # the row: the prompted prefill's shape, the custom path's call
    err = float((out.float() - ref).abs().max())
    ms, wall = time_ms(torch, lambda i: fa.flash_mha(q, k, v, causal=True,
                                                     scale=scale))
    plain_ms, _ = time_ms(torch, lambda i: fa.plain_flash_mha(
        q, k, v, causal=True, scale=scale))
    lib_ms = sdpa_ms(q, k, v, causal=True)
    # causal, row i needs i + 1 keys: 4 * D flops for each (row, key) pair
    b_ms, b_by = bound(4 * H * lq * D * 2, 4 * H * D * lq * (lq + 1) // 2,
                       PEAK_BF16_TENSOR)
    print(f"flash causal [1,{H},{lq},{D}] bf16: {ms * 1e3:.2f} us (bound "
          f"{b_ms * 1e3:.3f} us, {b_by}; plain {plain_ms * 1e3:.2f}; SDPA "
          f"{lib_ms * 1e3:.2f})")
    results["flash_attention_causal"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, host_call_ms=wall,
        plan=fa.causal_plan(lq, lq, lq, H, sms), rel_err_vs_plain=ferrs,
        cases=fcases)


def probe_kernels():
    """``megakernel_probes``, the probes' module of ``tools/``, imported
    from its directory (importing it registers its source with
    ``ops/_build``); the scripts import the same module, so its launch
    counts are one."""
    path = os.path.join(HERE, "tools")
    if path not in sys.path:
        sys.path.insert(0, path)
    import megakernel_probes
    return megakernel_probes


def loop_ms(torch, fns):
    """Device time of the calls ``fns`` run in order, each queued behind its
    own spin (:func:`segments_ms`), the mean of two runs: the loops of small
    PyTorch calls over the panels launch more kernels than the queue
    holds."""
    t = time.perf_counter()
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    runs = [segments_ms(torch, fns, host_ms) for _ in range(2)]
    if None in runs:
        raise SmokeFailure("the host could not queue a loop's panels ahead "
                           "of the device")
    return sum(runs) / len(runs)


def probes_phase(torch, results, gen):
    """The megakernel design probes (``tools/megakernel_probes.cu``, the
    four TPU kernels of ``benchmarks/megakernel_probe{,2,3}.py``) against
    their plain versions at the scripts' shapes: 128 int8 panels [1280,
    1280] (210 MB), head-major at rows 60 (42 panels) and 20 (128), every
    mode.  bf16 outputs within one bf16 step of the plain version's, the
    relayout's totals within 1e-2; 9a also within one bf16 step of the loop
    of PyTorch calls over the panels (``torch_baseline_flat``, the
    counterpart of ``probe_xla``).  Times each kernel, its plain version and
    the loop of its plain version over the panels (``library_ms``: no one
    PyTorch call computes these functions); 9a's loop is
    ``torch_baseline_flat``, and it also reports one ``torch.matmul`` of x
    against the blob dequantised to bf16 beforehand, times the scale, and
    its own kernel at the megakernel's first GEMV item (32 columns by a
    quarter of K, before its whole-K items), on a block per item and on the
    megakernel's grid of one block an SM.  Bounds: the bytes at 3.35 TB/s (2 flops a weight byte are far
    below)."""
    mp = probe_kernels()
    dev = torch.device("cuda")
    P, K, N = mp.NP, mp.K, mp.N
    t = time.perf_counter()

    def randint(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    blob = randint(P, K, N)
    x = (randn(1, K) * 0.1).bfloat16()
    scales = torch.rand((P, 1, N), generator=gen, device=dev) * 0.01
    kv = (randn(1, mp.H, mp.D, mp.KV_COLS) * 0.1).bfloat16()
    ctx = randn(mp.HP, mp.DL) * 0.1
    hm = {}
    for rows in (60, 20):
        np_ = mp.hm_panels(rows)
        hm[rows] = (randint(np_, rows, K, mp.D), (randn(rows, 1, K) * 0.1)
                    .bfloat16(), torch.rand((np_, rows, mp.D), generator=gen,
                                            device=dev))
    torch.cuda.synchronize()
    print(f"probes: data {time.perf_counter() - t:.1f} s")

    def mode(row, tag, fn, plain, panel, n_panels, n_bytes, int8_bytes,
             rtol=2 ** -7):
        """Check and time one mode; ``panel(i)``: the plain version on
        panel i alone (the loop)."""
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        print(f"{row} ({tag}): max abs err vs plain {err:.3e}, rel "
              f"{rel_err(out, ref):.3e}")
        check(out.shape == ref.shape and out.dtype == torch.bfloat16
              and bool(torch.isfinite(out).all())
              and mp.within(out, ref, rtol),
              f"{row} ({tag}) within {rtol:.3g} (relative) of plain")
        ms, wall = time_ms(torch, lambda i: fn())
        plain_ms, _ = time_ms(torch, lambda i: plain(), iters=5)
        lib_ms = loop_ms(torch, [lambda i=i: panel(i)
                                 for i in range(n_panels)])
        b_ms, b_by = bound(n_bytes, 2 * int8_bytes, PEAK_FP32_CUDA_CORES)
        print(f"{row} ({tag}): {ms * 1e3:.2f} us ({int8_bytes / ms / 1e6:.1f}"
              f" GB/s of int8; bound {b_ms * 1e3:.2f} us, {b_by}); plain "
              f"{plain_ms * 1e3:.2f} us; the loop over the panels "
              f"{lib_ms * 1e3:.2f} us")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms, host_call_ms=wall,
                    bytes=n_bytes)

    def row(name, modes, top):
        results[name] = dict(
            {k: modes[top][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            max_abs_err=max(m["max_abs_err"] for m in modes.values()),
            times_are=f"the {top} mode", modes=modes)

    # 9a: checked against the loop too; the megakernel's first item and grid
    flat_bytes = P * K * N + P * N * 4 + K * 2 + P * N * 2
    check(mp.within(mp.probe_flat(blob, x, scales),
                    mp.torch_baseline_flat(blob, x, scales)),
          "probe_flat_gemv within one bf16 step of torch_baseline_flat")
    flat = mode("probe_flat_gemv", "flat",
                lambda: mp.probe_flat(blob, x, scales),
                lambda: mp.plain_probe_flat(blob, x, scales),
                lambda i: mp.baseline_flat_panel(blob, x, scales, i), P,
                flat_bytes, P * K * N)
    wd = blob.bfloat16()
    flat["library_dequantised_matmul_ms"], _ = time_ms(
        torch, lambda i: torch.matmul(x, wd) * scales)
    del wd
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for key, blocks in (("megakernel_item_ms", 0), ("megakernel_grid_ms",
                                                    sms)):
        flat[key], _ = time_ms(torch, lambda i: mp.probe_flat(
            blob, x, scales, cols=mp.MEGAKERNEL_ITEM[0],
            ksplit=mp.MEGAKERNEL_ITEM[1], blocks=blocks))
    print(f"probe_flat_gemv: torch.matmul on the dequantised blob "
          f"{flat['library_dequantised_matmul_ms'] * 1e3:.2f} us; the "
          f"megakernel's first item {flat['megakernel_item_ms'] * 1e3:.2f} "
          "us, on "
          f"its grid of {sms} blocks {flat['megakernel_grid_ms'] * 1e3:.2f} "
          "us")
    row("probe_flat_gemv", {"flat": flat}, "flat")

    modes = {}
    for rows, (blob_hm, xb, s_hm) in hm.items():
        modes[f"hm{rows}"] = mode(
            "probe_hm_gemv", f"rows {rows}, {blob_hm.shape[0]} panels",
            lambda: mp.probe_hm(blob_hm, xb, s_hm),
            lambda: mp.plain_probe_hm(blob_hm, xb, s_hm),
            lambda i: mp.plain_probe_hm(blob_hm[i:i + 1], xb, s_hm[i:i + 1]),
            blob_hm.shape[0], blob_hm.numel() + s_hm.numel() * 6
            + xb.numel() * 2, blob_hm.numel())
    row("probe_hm_gemv", modes, "hm60")

    modes = {}
    for m in mp.RELAYOUT_MODES:
        modes[m] = mode(
            "probe_relayout", m, lambda: mp.probe_relayout(blob, x, kv, m),
            lambda: mp.plain_probe_relayout(blob, x, kv, m),
            lambda i: mp.plain_probe_relayout(blob[i:i + 1], x, kv, m), P,
            P * K * N + K * 2 + P * N * 2
            + (kv.numel() * 2 if m == "reshape" else 0), P * K * N,
            rtol=1e-2 if m == "reshape" else 2 ** -7)
    row("probe_relayout", modes, "reshape")

    modes = {}
    for m in mp.PAIR_MODES:
        k = mp.DL if m == "gemv" else K
        modes[m] = mode(
            "probe_pair_proj", m, lambda: mp.probe_pair_proj(blob, ctx, m),
            lambda: mp.plain_probe_pair_proj(blob, ctx, m),
            lambda i: mp.plain_probe_pair_proj(blob[i:i + 1], ctx, m), P,
            P * k * N + ctx.numel() * 4 + P * N * 2, P * k * N)
    row("probe_pair_proj", modes, "pair_loop")


def random_openai_state(np, config, rng):
    """A seeded OpenAI-format Whisper state dict: linear weights N(0, 0.02),
    LayerNorm weights 1 + N(0, 0.02), biases N(0, 0.02)."""
    c = config
    d = c.n_text_state
    sd = {}

    def normal(shape, std=0.02, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * std + mean)

    def block(prefix, cross):
        sd[prefix + "attn_ln.weight"] = normal((d,), mean=1.0)
        sd[prefix + "attn_ln.bias"] = normal((d,))
        for name in ("query", "key", "value", "out"):
            sd[prefix + f"attn.{name}.weight"] = normal((d, d))
            if name != "key":
                sd[prefix + f"attn.{name}.bias"] = normal((d,))
        if cross:
            sd[prefix + "cross_attn_ln.weight"] = normal((d,), mean=1.0)
            sd[prefix + "cross_attn_ln.bias"] = normal((d,))
            for name in ("query", "key", "value", "out"):
                sd[prefix + f"cross_attn.{name}.weight"] = normal((d, d))
                if name != "key":
                    sd[prefix + f"cross_attn.{name}.bias"] = normal((d,))
        sd[prefix + "mlp_ln.weight"] = normal((d,), mean=1.0)
        sd[prefix + "mlp_ln.bias"] = normal((d,))
        sd[prefix + "mlp.0.weight"] = normal((4 * d, d))
        sd[prefix + "mlp.0.bias"] = normal((4 * d,))
        sd[prefix + "mlp.2.weight"] = normal((d, 4 * d))
        sd[prefix + "mlp.2.bias"] = normal((d,))

    sd["encoder.conv1.weight"] = normal((d, c.n_mels, 3))
    sd["encoder.conv1.bias"] = normal((d,))
    sd["encoder.conv2.weight"] = normal((d, d, 3))
    sd["encoder.conv2.bias"] = normal((d,))
    sd["encoder.ln_post.weight"] = normal((d,), mean=1.0)
    sd["encoder.ln_post.bias"] = normal((d,))
    for i in range(c.n_audio_layer):
        block(f"encoder.blocks.{i}.", cross=False)
    sd["decoder.token_embedding.weight"] = normal((c.n_vocab, d))
    sd["decoder.positional_embedding"] = normal((c.n_text_ctx, d), 0.01)
    sd["decoder.ln.weight"] = normal((d,), mean=1.0)
    sd["decoder.ln.bias"] = normal((d,))
    for i in range(c.n_text_layer):
        block(f"decoder.blocks.{i}.", cross=True)
    return sd


@contextlib.contextmanager
def plain_kernels():
    """Route the attention layer to the kernels' plain versions (for the
    teacher-forced comparison only; the port itself never does this)."""
    from eddie_wang_hackathon2023_tpu_torch.layers import attention as la
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
    saved = (la.fused_decode_attention, la.flash_mha,
             la.fused_paged_decode_attention,
             la.fused_paged_window_attention, la.fused_paged_beam_attention,
             iq.quant_matmul_int4)
    la.fused_decode_attention = da.plain_decode_attention
    la.flash_mha = lambda q, k, v, causal=False, scale=None, \
        kv_valid_len=None, out=None, min_causal_rows=None: out.copy_(
            fa.plain_flash_mha(q, k, v, causal, scale, kv_valid_len))
    la.fused_paged_decode_attention = da.plain_paged_decode_attention
    la.fused_paged_window_attention = da.plain_paged_window_attention
    la.fused_paged_beam_attention = da.plain_paged_beam_attention
    iq.quant_matmul_int4 = iq.plain_quant_matmul_int4
    try:
        yield
    finally:
        (la.fused_decode_attention, la.flash_mha,
         la.fused_paged_decode_attention, la.fused_paged_window_attention,
         la.fused_paged_beam_attention, iq.quant_matmul_int4) = saved


def build_whisper(torch, np, config, device, recipe, label):
    """Whisper for ``recipe`` on ``device`` with seeded random weights (the
    static cross-KV scales calibrated on the seeded mel's encoder output),
    and that mel: dict(config, recipe, enc, dec, ckv, mel, mel_t,
    dec_float), ``dec_float`` the decoder's float state (numpy, on the
    host), from which :func:`decoder_built` makes the decoder of another
    recipe."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        cross_kv_from_jax_state, from_jax_state, quantize_states)
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.convert import (
        cross_kv_state_dict, decoder_state_dict, encoder_state_dict)
    from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import \
        calibrate_cross_kv_scales

    dtype = getattr(torch, config.dtype)
    t0 = time.time()
    rng = np.random.default_rng(SEED)
    sd = random_openai_state(np, config, rng)
    enc_f = encoder_state_dict(sd, config)
    dec_f = decoder_state_dict(sd, config)
    ckv_f = cross_kv_state_dict(sd, config)
    del sd
    # the recipe without ckv8 first: the static cross-KV scales are
    # calibrated on this utterance's encoder output
    no_ckv = "+".join(p for p in recipe.split("+") if p != "ckv8")
    enc_q, dec_q, _ = quantize_states(enc_f, dec_f, ckv_f, no_ckv)
    del enc_f
    enc, dec, _ = from_jax_state(enc_q, dec_q, ckv_f, config, recipe=no_ckv,
                                 device=device)
    del enc_q, dec_q
    mel = np.random.default_rng(SEED + 1).standard_normal(
        (1, config.n_mels, 2 * config.n_audio_ctx), dtype=np.float32)
    mel_t = torch.from_numpy(mel).to(device).to(dtype)
    with torch.inference_mode():
        xa = enc(mel_t)
    scales = calibrate_cross_kv_scales(ckv_f, [xa.float()], device=device)
    ckv = cross_kv_from_jax_state({**ckv_f, "kv_scale": scales}, config,
                                  recipe=recipe, device=device)
    del ckv_f
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    print(f"[{label}] {recipe}, {config.n_audio_layer}+{config.n_text_layer}"
          f" layers of width {config.n_text_state}, built in "
          f"{time.time() - t0:.1f} s")
    return dict(config=config, recipe=recipe, enc=enc, dec=dec, ckv=ckv,
                mel=mel, mel_t=mel_t, dec_float=dec_f)


def decoder_built(torch, np, built, recipe):
    """``built`` (from :func:`build_whisper`) with its decoder made anew
    for ``recipe`` from the same seeded float state (``dec_float``,
    quantised again), beside the same encoder and cross-KV: ``recipe``'s
    encoder and cross-KV parts must be ``built``'s."""
    from eddie_wang_hackathon2023_tpu_torch.models._state import \
        unstack_blocks
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        Recipe, quantize_states)
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import \
        WhisperDecoder
    r, mine = Recipe.parse(recipe), Recipe.parse(built["recipe"])
    check(r.encoder == mine.encoder and r.ckv8 == mine.ckv8,
          f"{recipe} shares {built['recipe']}'s encoder and cross-KV")
    no_ckv = "+".join(p for p in recipe.split("+") if p != "ckv8")
    _, dec_q, _ = quantize_states({}, built["dec_float"], {}, no_ckv)
    dev = built["dec"].positional_embedding.device
    with torch.device(dev):
        dec = WhisperDecoder(built["config"], r.decoder,
                             quantize_lm_head=r.lm_head)
    dec.load_state_dict(unstack_blocks(dec_q))
    return {**built, "dec": dec.eval(), "recipe": recipe}


def woq4_scanned_path(torch, np, config, device="cuda"):
    """The woq4_scanned path: Whisper ``config`` (the scanned path's
    depth) built for WOQ4_SCANNED_RECIPE, an int4 encoder (each of its
    linears one launch of the int4 kernel's prefill entry at M 1536) and
    an int4 decoder layer by layer (its decode entry once a linear a step),
    through :func:`main_path` without the megakernel."""
    return main_path(torch, np, config=config, device=device,
                     decode_megakernel=False, recipe=WOQ4_SCANNED_RECIPE,
                     label="woq4_scanned", slope=False)


def whisper_variant_paths(torch, np, built, main, device="cuda"):
    """The woq4 and float paths on the main path's model (``built``; the
    main path's numbers ``main``): its decoder made anew for WOQ4_RECIPE
    (int4 panels, groups of 128) and FLOAT_RECIPE (a float decoder: bf16
    panels) by :func:`decoder_built`, each through :func:`main_path` with
    the megakernel (one launch a step), printed beside the main path's
    numbers with the share of its tokens equal to the main path's.
    Returns ({label: numbers}, {label: counts})."""
    on_card = torch.device(device).type == "cuda"
    out, counts = {}, {}
    for label, recipe in (("woq4", WOQ4_RECIPE), ("float", FLOAT_RECIPE)):
        t = time.time()
        b = decoder_built(torch, np, built, recipe)
        sync(torch, torch.device(device))
        print(f"[{label}] decoder made for {recipe} from the main path's "
              f"float state in {time.time() - t:.1f} s")
        # the CPU rehearsal skips the 80-token calls of the slope
        e2e, c = main_path(torch, np, device=device,
                           decode_megakernel=None if on_card else True,
                           label=label, built=b, slope=on_card)
        del b
        if on_card:
            torch.cuda.empty_cache()
        same = float(np.mean([a == m for a, m in zip(e2e["tokens"],
                                                     main["tokens"])]))
        e2e["tokens_equal_main"] = same
        print(f"[{label}] beside main in this run: " + ", ".join(
            f"{k} {e2e.get(k)} vs {main.get(k)}"
            for k in ("utt_per_s", "slope_ms_per_token", "decoder_step_ms",
                      "device_busy_ms_per_step", "device_idle_share",
                      "peak_gib")) + f"; tokens equal to main's {same:.3f}")
        out[label], counts[label] = e2e, c
    return out, counts


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def wall_s(torch, device, fn):
    """Seconds of one call of ``fn``, from a synchronised start to a
    synchronised end."""
    sync(torch, device)
    t = time.perf_counter()
    fn()
    sync(torch, device)
    return time.perf_counter() - t


def whisper_pipeline(built, decode_megakernel, sample_len=SAMPLE_LEN,
                     language="en", **options):
    """The pipeline over ``built``'s model (from :func:`build_whisper`),
    with EOT suppressed so every run decodes the full ``sample_len`` tokens
    (the JAX bench gets the same effect from zero weights); ``language``
    None detects it; ``options`` are further ``DecodingOptions``
    (beam_size, prompt, temperature, best_of, without_timestamps)."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
        DecodingOptions, WhisperPipeline)
    opts = DecodingOptions(language=language, sample_len=sample_len,
                           suppress_tokens=f"-1,{TOK_EOT}", **options)
    return WhisperPipeline(built["config"], built["enc"], built["dec"],
                           built["ckv"], opts,
                           decode_megakernel=decode_megakernel)


def recorded_calls(dec, fn):
    """``fn()``, recording every decoder call (forward pre-hook: (args,
    kwargs)) for :func:`replay_logits`."""
    calls = []
    hook = dec.register_forward_pre_hook(
        lambda mod, args, kwargs: calls.append((args, dict(kwargs))),
        with_kwargs=True)
    try:
        fn()
    finally:
        hook.remove()
    return calls


def counted(torch, device, mods, fn):
    """(``fn()``, the launch counts of the modules ``mods``), the counts
    set to 0 just before the call and read just after it."""
    for m in mods:
        m.reset_launches()
    res = fn()
    sync(torch, device)
    counts = {}
    for m in mods:
        counts.update(m.launches)
    return res, counts


def nonzero(counts):
    """The launch counts that are not 0."""
    return {k: v for k, v in counts.items() if v}


def replay_logits(torch, dec, calls, rows, plain, n_calls):
    """Logits [n_calls, rows, vocab] of the first recorded decoder calls
    (forward pre-hook: (args, kwargs)), on a fresh cache, through the
    kernels or through their plain versions on the scanned path (no
    megakernel)."""
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    logits = []
    with ctx:
        cache = dec.new_kv_cache(rows)
        for (tok, _, cross_kv, widx, seq), kw in calls[:n_calls]:
            if plain:
                kw = {**kw, "megakernel_blobs": None}
            lg, cache = dec(tok, cache, cross_kv, widx, seq, **kw)
            logits.append(lg[:, -1])
    return torch.stack(logits)


def encoder_errors(torch, enc, mel_t, ref_ctx, label,
                   ctx=contextlib.nullcontext):
    """The encoder as it runs against the same under the context
    ``ref_ctx()``: each block on the same input (the reference's output of
    the block before), then the whole encoder.  Returns (largest rms rel
    err of a block, max rel err and rms rel err of the whole encoder)."""
    import torch.nn.functional as F

    from eddie_wang_hackathon2023_tpu_torch.functional import gelu
    x = gelu(enc.conv2(gelu(enc.conv1(mel_t)))).transpose(1, 2)
    x = x + enc.positional_embedding.to(x.dtype)
    valid = x.shape[1]                     # 1500, padded to 1536
    pad = (-valid) % 128 if valid >= 128 else 0
    x = F.pad(x, (0, 0, 0, pad))
    vl = valid if pad else None
    block_errs = []
    for block in enc.blocks:
        with ctx():
            y_k = block(x, valid_len=vl)
        with ref_ctx():
            y_p = block(x, valid_len=vl)
        block_errs.append(float((y_k.float() - y_p.float()).norm()
                                / y_p.float().norm()))
        x = y_p
    with ctx():
        xa_k = enc(mel_t)
    with ref_ctx():
        xa_p = enc(mel_t)
    rms = float((xa_k.float() - xa_p.float()).norm() / xa_p.float().norm())
    check(bool(torch.isfinite(xa_k).all()), f"[{label}] encoder output finite")
    return max(block_errs), rel_err(xa_k, xa_p), rms


def main_path(torch, np, config=None, device="cuda", decode_megakernel=None,
              recipe=None, label="main", beam=None, built=None, slope=True):
    """One path on ``device``: the model built with ``recipe`` (default the
    bench recipe; or ``built``, from :func:`build_whisper` or
    :func:`kv8_built`), transcription
    with ``decode_megakernel`` (None: the pipeline's default, on with a
    card) and ``beam`` (the beam size; None is greedy), the launch counts
    of that run, the kernel-vs-plain checks and the timings (the 80-token
    decode slope only greedy and with ``slope``).  A smaller
    ``config`` and the CPU rehearse it without a card (the launch counts
    are then not checked).  Returns (end-to-end numbers, launch
    counts)."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        BENCH_RECIPE, Recipe, whisper_config)
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq

    device = torch.device(device)
    on_card = device.type == "cuda"
    if built is None:
        built = build_whisper(
            torch, np, config or whisper_config("large-v2", dtype="bfloat16"),
            device, recipe or BENCH_RECIPE, label)
    config, recipe = built["config"], built["recipe"]
    enc, dec = built["enc"], built["dec"]
    mel, mel_t = built["mel"], built["mel_t"]
    dtype = getattr(torch, config.dtype)
    sqenc = "sqenc" in recipe
    kv8 = dec.blocks[0].attn.use_int8_kv_cache
    fp8 = dec.blocks[0].attn.use_fp8_kv_cache
    self_dtype = dec.blocks[0].attn.kv_cache_dtype
    check(kv8 == ("kv8" in recipe.split("+"))
          and dec.new_kv_cache(1, 4).dtype == self_dtype
          and self_dtype == (torch.int8 if kv8 else torch.float8_e4m3fn
                             if fp8 else dtype),
          f"[{label}] the decoder's self cache is {self_dtype}")
    pipe = whisper_pipeline(built, decode_megakernel, beam_size=beam)
    rows = pipe.beam                     # decoder rows per utterance
    blobs = pipe._megakernel_blobs(rows)
    mk_on = blobs is not None
    # the recipe's weights: int4 (decoder, and encoder without sqenc),
    # float, or int8
    r = Recipe.parse(recipe)
    dec_int4 = r.decoder.is_int4_weight_only()
    enc_int4 = r.encoder.is_int4_weight_only()
    mode = None
    if mk_on:
        int4 = mk.blob_int4(blobs)
        mode = ("int4 panels, " + (f"groups of {config.n_text_state // int4}"
                                   if int4 else "per channel")
                if int4 is not None else f"{blobs.wblob.dtype} panels"
                .replace("torch.", ""))
        check((int4 is not None) == dec_int4
              and (blobs.wblob.is_floating_point()
                   == (not r.decoder.is_weight_only())),
              f"[{label}] the megakernel's weights follow the recipe "
              f"({mode})")
    print(f"[{label}] decode path: "
          + (f"the megakernel ({mode}), one launch per step" if mk_on
             else "layer by layer (scanned)")
          + (f", beam search with {beam} beams" if beam else ""))
    # warm-up, recording every decoder call (tokens, cache column, length,
    # and with beams the indirection table, which encodes the parents) for
    # the teacher-forced replay below
    calls = recorded_calls(dec, lambda: pipe.transcribe(mel))
    sync(torch, device)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res, counts = counted(torch, device, (da, fa, mk, iq),
                          lambda: pipe.transcribe(mel)[0])
    peak_gib = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                else float("nan"))
    steps = pipe.decode_steps
    n_layer = config.n_text_layer
    print(f"[{label}] {len(res.tokens)} tokens, {steps} decode steps, "
          f"launches {counts}")
    check(steps == SAMPLE_LEN - 1 and len(res.tokens) == SAMPLE_LEN
          and len(calls) == SAMPLE_LEN,
          f"[{label}] transcription decoded {SAMPLE_LEN} tokens")
    if on_card:
        if beam:
            check(counts["beam_decode_attention"] == n_layer * steps
                  and counts["decode_attention_int8"] == n_layer * steps
                  and counts["decode_attention_bf16"] == 0
                  and counts["out_proj_gemv"] == 0
                  and counts["decoder_megakernel"] == 0,
                  f"[{label}] beam decode kernel (self) and decode kernel at"
                  f" batch {rows} (cross) launched {n_layer} times each per "
                  "decode step, no megakernel or GEMV launch")
        elif mk_on:
            check(counts["decoder_megakernel"] == steps
                  and counts["decode_attention_int8"] == 0
                  and counts["decode_attention_bf16"] == 0
                  and counts["decode_attention_e4m3"] == 0
                  and counts["out_proj_gemv"] == 0,
                  f"[{label}] one megakernel launch per decode step, no "
                  "decode-attention or GEMV launch in the decode loop")
        else:
            # self and cross calls: with kv8 both over int8 caches; int4
            # weights take no GEMV epilogue (the out-projections are int4
            # linears)
            n_self = n_layer * steps
            check(counts["decode_attention_int8"]
                  == n_layer * steps + (n_self if kv8 else 0)
                  and counts["decode_attention_bf16"]
                  == (0 if kv8 or fp8 else n_self)
                  and counts["decode_attention_e4m3"]
                  == (n_self if fp8 else 0)
                  and counts["out_proj_gemv"]
                  == (0 if dec_int4 else 2 * n_layer * steps)
                  and counts["decoder_megakernel"] == 0,
                  f"[{label}] decode kernels launched 2 x {n_layer} per "
                  "decode step"
                  + ("" if dec_int4 else f" (+ 2 x {n_layer} GEMV)")
                  + (", the self calls over the int8 cache" if kv8 else "")
                  + (", the self calls over the e4m3 cache" if fp8
                     else ""))
        # int4 linears: six a decoder layer in the prompt prefill and (layer
        # by layer) in each decode step, four an encoder layer
        want = ((6 * n_layer * (1 if mk_on else 1 + steps) if dec_int4
                 else 0) + (4 * config.n_audio_layer if enc_int4 else 0))
        check(counts["int4_quant_matmul"] == want,
              f"[{label}] the int4 kernel launched {want} times "
              f"(launched {counts['int4_quant_matmul']})")
        entry = "flash_attention_f32" if sqenc else "flash_attention"
        check(counts[entry] == config.n_audio_layer,
              f"[{label}] flash kernel ({entry}) launched "
              f"{config.n_audio_layer} times per utterance")
    check(all(0 <= t < config.n_vocab for t in res.tokens)
          and isinstance(res.text, str) and np.isfinite(res.avg_logprob),
          f"[{label}] transcription tokens in range, finite log-probability")

    # teacher forcing: the kernel path and the plain scanned path replay the
    # recorded decoder calls (the same tokens, cross K/V and, with beams,
    # indirection tables); logits must agree
    n_check = 8

    with torch.inference_mode():
        # Per block: the same input through the block with the flash kernel
        # and with its plain version.  A bf16 rounding apart in the
        # attention output (2^-9 relative) can move a per-token int8 step of
        # the SmoothQuant GEMMs after it (1/127 of the token's amax), so a
        # block may differ by a few such steps: gate 2e-2.  Over the whole
        # encoder 32 random-weight layers amplify these, so that gate only
        # catches gross errors.
        e_blk, e_xa, rms_xa = encoder_errors(torch, enc, mel_t, plain_kernels,
                                             label)
        print(f"[{label}] encoder blocks, kernel vs plain on the same input: "
              f"largest rms rel err {e_blk:.3e}; whole encoder: max rel err "
              f"{e_xa:.3e}, rms rel err {rms_xa:.3e}")
        check(e_blk < 2e-2, f"[{label}] each encoder block, flash kernel vs "
              "plain (rms rel 2e-2)")
        check(rms_xa < 1e-1, f"[{label}] encoder output, kernel path vs "
              "plain path (rms rel 1e-1)")
        lk, lp = (replay_logits(torch, dec, calls, rows, plain, 1 + n_check)
                  for plain in (False, True))
    e_lg = rel_err(lk, lp)
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"[{label}] teacher-forced logits (prefill + {n_check} steps), "
          f"kernel path vs plain scanned path: rel err {e_lg:.3e}, argmax "
          f"agreement {agree:.3f}")
    check(bool(torch.isfinite(lk).all()), f"[{label}] decoder logits finite")
    check(e_lg < 5e-2, f"[{label}] teacher-forced logits agree (rel 5e-2 of "
          "max |logit|)")

    # where a decoder step's time goes (wall, device-busy, per kernel), and
    # the share of the casts that is the int8 lm_head's
    step_info = {}
    if on_card:
        step_info = step_timing(
            torch, dec, replayer(dec, calls, dec.new_kv_cache(rows)), label)
        with torch.inference_mode():
            lm_cast_ms, _ = time_ms(torch, lambda i: dec.lm_head_qweight.to(
                dtype), iters=10)
        step_info["lm_head_cast_ms_per_step"] = lm_cast_ms
        print(f"  int8 lm_head cast alone: {lm_cast_ms * 1e3:.1f} us/step")

    # end-to-end timing: best of 3 at 40 tokens and, greedy only, at 80
    # tokens for the decode slope (one of each in a CPU rehearsal)
    def best(p, n=3 if on_card else 1):
        return min(wall_s(torch, device, lambda: p.transcribe(mel))
                   for _ in range(n))

    t40 = best(pipe)
    t80 = slope_ms = None
    if not beam and slope:
        pipe80 = whisper_pipeline(built, decode_megakernel,
                                  sample_len=2 * SAMPLE_LEN)
        pipe80._mk_blobs = blobs      # the same weight image, packed once
        pipe80.transcribe(mel)
        t80 = best(pipe80)
        slope_ms = (t80 - t40) / SAMPLE_LEN * 1e3
    print(f"[{label}] end to end: {1 / t40:.4f} utt/s ({t40 * 1e3:.1f} ms per "
          f"utterance, {SAMPLE_LEN} tokens"
          + (f", beam {beam}" if beam else "") + ")"
          + ("" if slope_ms is None else
             f"; decode slope {slope_ms:.3f} ms/token (80-token call "
             f"{t80 * 1e3:.1f} ms)")
          + f"; peak memory {peak_gib:.2f} GiB")
    e2e = dict(**step_info, recipe=recipe, megakernel=mk_on,
               megakernel_mode=mode, tokens=[int(t) for t in res.tokens],
               beam=beam,
               n_audio_layer=config.n_audio_layer,
               n_text_layer=config.n_text_layer, utt_per_s=1 / t40,
               ms_per_utt=t40 * 1e3, slope_ms_per_token=slope_ms,
               peak_gib=peak_gib, logits_rel_err=e_lg,
               logits_argmax_agreement=agree,
               encoder_block_rms_rel_err=e_blk, encoder_rel_err=e_xa,
               encoder_rms_rel_err=rms_xa)
    return e2e, counts


def custom_path(torch, np, built, device="cuda", label="custom"):
    """The custom path: the main path's model (``built``, from
    :func:`build_whisper`) transcribing the same mel with the built-in
    dispatch, then with the user kernel of ``examples/custom_kernel_torch``
    installed by ``set_custom_mha`` (it must take the encoder's and the
    prompt prefill's attention, one call a layer each, and kernel 2 must
    not launch), then without it again and with a previous-text prompt of
    ``PROMPT_LEN`` tokens (kernel 2 must launch again: the encoder, and the
    prompted prefill in its causal mode).  Checks the encoder with the user
    kernel against the built-in one and the teacher-forced logits of the
    hooked run against the plain path, and times the transcription with
    and without the hook, in turns.  Returns (end-to-end numbers, launch
    counts of the three counted transcriptions together)."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa

    ck = example_kernel()
    device = torch.device(device)
    on_card = device.type == "cuda"
    config, sqenc = built["config"], "sqenc" in built["recipe"]
    enc, dec = built["enc"], built["dec"]
    mel, mel_t = built["mel"], built["mel_t"]
    n_enc, n_dec = config.n_audio_layer, config.n_text_layer

    def hooked():
        return custom_mha(ck.custom_flash_mha)

    def transcribe(p, hook=False):
        with hooked() if hook else contextlib.nullcontext():
            return p.transcribe(mel)[0]

    # the megakernel decode, as on the main path (asked for on the CPU)
    mk_on = None if on_card else True
    pipe = whisper_pipeline(built, mk_on)
    prompt = np.random.default_rng(SEED + 2).integers(
        0, TOK_EOT, PROMPT_LEN).tolist()
    pipe_p = whisper_pipeline(built, mk_on, prompt=prompt)
    # warm-up (the user kernel's first launch), recording the hooked run's
    # decoder calls for the teacher-forced replay
    transcribe(pipe)
    calls = recorded_calls(dec, lambda: transcribe(pipe, hook=True))
    transcribe(pipe_p)
    sync(torch, device)

    mods = (da, fa, mk, ck)
    res_off, c_off = counted(torch, device, mods, lambda: transcribe(pipe))
    res_on, c_on = counted(torch, device, mods,
                           lambda: transcribe(pipe, hook=True))
    res_p, c_p = counted(torch, device, mods, lambda: transcribe(pipe_p))
    counts = {k: c_off[k] + c_on[k] + c_p[k] for k in c_off}
    n_prefill = len(pipe_p.initial_tokens)
    print(f"[{label}] launches without the hook {c_off}; with it {c_on}; "
          f"without it, prompted ({n_prefill}-token prefill) {c_p}")
    check(c_on["custom_mha"] == n_enc + n_dec
          and c_off["custom_mha"] == c_p["custom_mha"] == 0,
          f"[{label}] the hook took {n_enc} encoder and {n_dec} prompt "
          "prefill calls a transcription, none once removed")
    builtin = ("flash_attention", "flash_attention_f32",
               "flash_attention_causal", "flash_attention_causal_f32")
    enc_flash = "flash_attention_f32" if sqenc else "flash_attention"
    if on_card:
        enc_user = "custom_fmha_f32" if sqenc else "custom_fmha"
        check(all(c_on[k] == 0 for k in builtin)
              and c_on[enc_user] == n_enc
              and c_on["custom_fmha"] + c_on["custom_fmha_f32"]
              == n_enc + n_dec,
              f"[{label}] with the hook: the user kernel launched {n_enc} "
              f"times in the encoder ({enc_user}) and {n_dec} in the prefill,"
              " kernel 2 never")
        check(c_off[enc_flash] == n_enc
              and c_off["custom_fmha"] == c_off["custom_fmha_f32"] == 0,
              f"[{label}] without the hook: kernel 2 ({enc_flash}) launched "
              f"{n_enc} times, the user kernel never")
        check(n_prefill == PROMPTED_PREFILL and c_p[enc_flash] == n_enc
              and c_p["flash_attention_causal"] == n_dec
              and c_p["custom_fmha"] == c_p["custom_fmha_f32"] == 0,
              f"[{label}] after set_custom_mha(None), prompted: kernel 2 "
              f"launched {n_enc} times in the encoder and {n_dec} times "
              f"causally in the {PROMPTED_PREFILL}-token prefill")
    for res in (res_off, res_on, res_p):
        check(len(res.tokens) == SAMPLE_LEN
              and all(0 <= t < config.n_vocab for t in res.tokens)
              and np.isfinite(res.avg_logprob),
              f"[{label}] transcription: {SAMPLE_LEN} tokens in range, "
              "finite log-probability")
    agree = res_on.tokens == res_off.tokens
    print(f"[{label}] tokens with the hook equal those without it: {agree}")

    n_check = 8
    with torch.inference_mode():
        # The user kernel (fp32 on CUDA cores) and kernel 2 (fp32 accuracy
        # from split bf16 products) differ by fp32 roundings, which can
        # move a per-token int8 step of the SmoothQuant GEMMs after the
        # attention: the main path's gates (2e-2 a block, rms 1e-1 whole)
        e_blk, e_xa, rms_xa = encoder_errors(
            torch, enc, mel_t, contextlib.nullcontext, label, ctx=hooked)
        print(f"[{label}] encoder blocks, user kernel vs kernel 2 on the same"
              f" input: largest rms rel err {e_blk:.3e}; whole encoder: max "
              f"rel err {e_xa:.3e}, rms rel err {rms_xa:.3e}")
        check(e_blk < 2e-2 and rms_xa < 1e-1, f"[{label}] encoder with the "
              "user kernel vs kernel 2 (rms rel 2e-2 a block, 1e-1 whole)")
        with hooked():
            lk = replay_logits(torch, dec, calls, 1, False, 1 + n_check)
        lp = replay_logits(torch, dec, calls, 1, True, 1 + n_check)
    e_lg = rel_err(lk, lp)
    agree_lg = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"[{label}] teacher-forced logits (prefill + {n_check} steps), the "
          f"hooked path vs the plain scanned path: rel err {e_lg:.3e}, "
          f"argmax agreement {agree_lg:.3f}")
    check(bool(torch.isfinite(lk).all()) and e_lg < 5e-2,
          f"[{label}] teacher-forced logits with the hook agree (rel 5e-2 "
          "of max |logit|)")

    # end to end, without and with the hook in turns (off, on, on, off,
    # off, on), best of 3 each
    times = {False: [], True: []}
    for on in (False, True, True, False, False, True):
        times[on].append(wall_s(torch, device,
                                lambda: transcribe(pipe, hook=on)))
    t_off, t_on = min(times[False]), min(times[True])
    print(f"[{label}] end to end: {1 / t_off:.4f} utt/s without the hook, "
          f"{1 / t_on:.4f} utt/s with it ({t_off * 1e3:.1f} and "
          f"{t_on * 1e3:.1f} ms per utterance, {SAMPLE_LEN} tokens); tokens "
          f"agree: {agree}")
    e2e = dict(recipe=built["recipe"], n_audio_layer=n_enc,
               n_text_layer=n_dec, utt_per_s_builtin=1 / t_off,
               utt_per_s_hook=1 / t_on, ms_per_utt_builtin=t_off * 1e3,
               ms_per_utt_hook=t_on * 1e3, tokens_agree=agree,
               hook_calls_per_utt=c_on["custom_mha"],
               prompted_prefill_len=n_prefill, logits_rel_err=e_lg,
               logits_argmax_agreement=agree_lg,
               encoder_block_rms_rel_err=e_blk, encoder_rel_err=e_xa,
               encoder_rms_rel_err=rms_xa)
    return e2e, counts


def kv8_built(torch, np, built, scales):
    """``built`` (the main path's model, from :func:`build_whisper`) with
    its decoder rebuilt for KV8_RECIPE: the same weights (shared, not
    copied) and the per-layer self-KV steps ``scales`` ([n_text_layer],
    amax / 127), stored as ``decoder_state_dict(int8_kv_scales=)`` stores
    them."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import Recipe
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import \
        WhisperDecoder
    dec = built["dec"]
    dev = dec.positional_embedding.device
    with torch.device("meta"):
        kv = WhisperDecoder(built["config"], Recipe.parse(KV8_RECIPE).decoder,
                            quantize_lm_head=dec.quantize_lm_head)
    t = np.asarray(scales, np.float32).reshape(-1, 1)
    state = dict(dec.state_dict())
    for i, (oq, qo) in enumerate(zip(1.0 / t, t)):
        state[f"blocks.{i}.attn.kv_orig_quant_scale"] = torch.from_numpy(
            oq).to(dev)
        state[f"blocks.{i}.attn.kv_quant_orig_scale"] = torch.from_numpy(
            qo).to(dev)
    kv.load_state_dict(state, assign=True)
    return {**built, "dec": kv.eval(), "recipe": KV8_RECIPE}


def kv8_paths(torch, np, built, device="cuda"):
    """The kv8 paths on the main path's model (``built``): the self-KV
    steps calibrated by ``calibrate_int8_kv`` on the main pipeline (the
    bench recipe, a bf16 self cache) over the seeded mel, the decoder
    rebuilt with them (:func:`kv8_built`), then :func:`main_path` through
    the megakernel (its int8 self mode; label ``kv8``) and layer by layer
    at full depth (kernel 1 over the int8 cache; ``kv8_scanned``, no
    slope); between them the main and kv8 transcriptions in turns.
    Returns (kv8 numbers, counts, kv8_scanned numbers, counts)."""
    from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import \
        calibrate_int8_kv
    on_card = torch.device(device).type == "cuda"
    t = time.time()
    pipe = whisper_pipeline(built, None if on_card else True)
    scales = calibrate_int8_kv(pipe, [built["mel"][0]])
    del pipe
    check(scales.shape == (built["config"].n_text_layer,)
          and bool(np.isfinite(scales).all() and (scales > 0).all()),
          "[kv8] calibrate_int8_kv gives a positive step a layer")
    print(f"[kv8] self-KV steps calibrated on the main pipeline in "
          f"{time.time() - t:.1f} s: {float(scales.min()):.5g} to "
          f"{float(scales.max()):.5g} (amax {float(scales.min()) * 127:.4g} "
          f"to {float(scales.max()) * 127:.4g})")
    kv = kv8_built(torch, np, built, scales)
    e2e, counts = main_path(torch, np, device=device,
                            decode_megakernel=None if on_card else True,
                            label="kv8", built=kv)
    # the host's clock moves between runs: the two recipes' transcriptions
    # (megakernel, 40 tokens) also in turns, main, kv8, main, kv8, ...
    dm = None if on_card else True
    pipes = dict(main=whisper_pipeline(built, dm),
                 kv8=whisper_pipeline(kv, dm))
    walls = dict(main=[], kv8=[])
    for name, p in pipes.items():
        p.transcribe(built["mel"])
    for _ in range(3):
        for name, p in pipes.items():
            walls[name].append(wall_s(torch, torch.device(device),
                                      lambda p=p: p.transcribe(built["mel"])))
    del pipes
    print("[kv8] in turns with main: " + "; ".join(
        f"{name} " + ", ".join(f"{t * 1e3:.1f}" for t in w)
        + f" ms an utterance (best {1 / min(w):.4f} utt/s)"
        for name, w in walls.items()))
    e2e["in_turns_ms_per_utt"] = {k: [t * 1e3 for t in w]
                                  for k, w in walls.items()}
    scan_e2e, scan_counts = main_path(torch, np, device=device,
                                      decode_megakernel=False,
                                      label="kv8_scanned", built=kv,
                                      slope=False)
    e2e["self_kv_steps"] = [float(scales.min()), float(scales.max())]
    e2e["self_kv_amax"] = [float(a) for a in scales * 127]
    return e2e, counts, scan_e2e, scan_counts


def fp8_built(torch, np, built, amax):
    """``built`` (from :func:`build_whisper`) with its decoder rebuilt on
    the same weights (shared, not copied) with an e4m3 self cache: the
    recipe's decoder mode with ``set_fp8_kv_cache()``, each layer's scales
    1 / s and s, s = ``fp8_scales_from_amax`` of the layer's ``amax`` (the
    value the kv8 calibration measures)."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import Recipe
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import \
        WhisperDecoder
    from eddie_wang_hackathon2023_tpu_torch.quantization.fp8_layers import \
        fp8_scales_from_amax
    dec = built["dec"]
    dev = dec.positional_embedding.device
    mode = Recipe.parse(built["recipe"]).decoder.set_fp8_kv_cache()
    with torch.device("meta"):
        f8 = WhisperDecoder(built["config"], mode,
                            quantize_lm_head=dec.quantize_lm_head)
    s = np.asarray([fp8_scales_from_amax(a) for a in amax],
                   np.float32).reshape(-1, 1)
    state = dict(dec.state_dict())
    for i, (oq, qo) in enumerate(zip(1.0 / s, s)):
        state[f"blocks.{i}.attn.kv_orig_quant_scale"] = torch.from_numpy(
            oq).to(dev)
        state[f"blocks.{i}.attn.kv_quant_orig_scale"] = torch.from_numpy(
            qo).to(dev)
    f8.load_state_dict(state, assign=True)
    return {**built, "dec": f8.eval()}


def self_kv_amax(torch, np, built, device):
    """The per-layer amax of the self cache that ``calibrate_int8_kv``
    measures (its steps times 127) on ``built``'s pipeline over the
    seeded mel."""
    from eddie_wang_hackathon2023_tpu_torch.quantization.calibration import \
        calibrate_int8_kv
    on_card = torch.device(device).type == "cuda"
    pipe = whisper_pipeline(built, None if on_card else True)
    return calibrate_int8_kv(pipe, [built["mel"][0]]) * 127


def fp8_path(torch, np, built, amax, main, device="cuda"):
    """The fp8 path on the main path's model: its decoder rebuilt with an
    e4m3 self cache (:func:`fp8_built`, scales from the kv8 calibration's
    per-layer ``amax``) through :func:`main_path` with the megakernel (its
    e4m3 self mode, one launch a step), then the main and fp8
    transcriptions in turns, beside the main path's numbers ``main`` with
    the share of its tokens equal to the main path's.  Returns (numbers,
    counts)."""
    on_card = torch.device(device).type == "cuda"
    f8 = fp8_built(torch, np, built, amax)
    dm = None if on_card else True
    e2e, counts = main_path(torch, np, device=device, decode_megakernel=dm,
                            label="fp8", built=f8, slope=on_card)
    pipes = dict(main=whisper_pipeline(built, dm),
                 fp8=whisper_pipeline(f8, dm))
    walls = dict(main=[], fp8=[])
    for p in pipes.values():
        p.transcribe(built["mel"])
    for _ in range(3):
        for name, p in pipes.items():
            walls[name].append(wall_s(torch, torch.device(device),
                                      lambda p=p: p.transcribe(built["mel"])))
    del pipes, f8
    same = float(np.mean([a == m for a, m in zip(e2e["tokens"],
                                                 main["tokens"])]))
    print("[fp8] in turns with main: " + "; ".join(
        f"{name} " + ", ".join(f"{t * 1e3:.1f}" for t in w)
        + f" ms an utterance (best {1 / min(w):.4f} utt/s)"
        for name, w in walls.items())
        + f"; tokens equal to main's {same:.3f}")
    e2e.update(in_turns_ms_per_utt={k: [t * 1e3 for t in w]
                                    for k, w in walls.items()},
               tokens_equal_main=same, self_kv_amax=[float(a)
                                                     for a in amax])
    return e2e, counts


def long_audio(np, config):
    """Seeded 16 kHz audio of LONG_WINDOWS windows of ``config`` (75 s on
    large-v2): a 440 Hz tone and noise."""
    from eddie_wang_hackathon2023_tpu_torch.audio import (HOP_LENGTH,
                                                          SAMPLE_RATE)
    n = int(LONG_WINDOWS * 2 * config.n_audio_ctx * HOP_LENGTH)
    t = np.arange(n, dtype=np.float64) / SAMPLE_RATE
    noise = np.random.default_rng(SEED + 2).standard_normal(n)
    return (0.1 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * noise).astype(
        np.float32)


def long_paths(torch, np, built, device="cuda"):
    """The detect, long and best_of paths on the main path's model
    (``built``, from :func:`build_whisper`), each with the launch counts
    of its run:

    * detect: ``detect_language`` on the seeded window (one ``[sot]``
      step through the layer-by-layer decoder), its probabilities summing
      to 1, the step's time;
    * long: ``transcribe_long`` with the language detected in each window,
      over LONG_WINDOWS windows of seeded audio, without timestamps and
      with EOT suppressed, so that it is exactly 3 windows (30 + 30 + 15 s
      on large-v2), each decoding SAMPLE_LEN tokens through the megakernel
      (with random weights and timestamps on, a seek of 2 frames a window
      could take thousands of windows);
    * best_of: one window, ``temperature=1.0``, ``best_of=BEST_OF``, EOT
      suppressed: BEST_OF rows layer by layer (kernel 1 at batch BEST_OF),
      two runs with the same seed sampling the same tokens, the first
      steps replayed through the plain scanned path.

    Returns (long numbers, counts, best_of numbers, counts)."""
    from eddie_wang_hackathon2023_tpu_torch.audio import (HOP_LENGTH,
                                                          SAMPLE_RATE)
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    from eddie_wang_hackathon2023_tpu_torch.text.languages import LANGUAGES
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    dm = None if on_card else True
    config, mel, enc, dec = (built["config"], built["mel"], built["enc"],
                             built["dec"])
    mods = (da, fa, mk)
    n_layer = config.n_text_layer
    entry = ("flash_attention_f32" if "sqenc" in built["recipe"]
             else "flash_attention")

    pipe = whisper_pipeline(built, dm, language=None,
                            without_timestamps=True)
    check(pipe._megakernel_blobs(1) is not None,
          "[long] each window decodes through the megakernel")
    with torch.inference_mode():
        xa = pipe.get_audio_features(mel)
        ckv = pipe.precompute_cross_kv(xa)
    pipe.detect_language(xa, ckv)
    (langs, probs), det_counts = counted(
        torch, dev, mods, lambda: pipe.detect_language(xa, ckv))
    p = probs[0]
    total = sum(p.values())
    check(langs[0] in LANGUAGES and abs(total - 1.0) < 1e-3
          and all(np.isfinite(v) for v in p.values()),
          "[detect] a language, its probabilities summing to 1 (1e-3)")
    top3 = sorted(p.items(), key=lambda kv: -kv[1])[:3]
    detect_ms = min(wall_s(torch, dev, lambda: pipe._detect(ckv))
                    for _ in range(5)) * 1e3
    print(f"[detect] {langs[0]}; top 3 " + ", ".join(
        f"{c} {v:.5f}" for c, v in top3) + f"; sum {total:.6f}; the step "
          f"{detect_ms:.3f} ms (best of 5); launches {nonzero(det_counts)}")

    audio = long_audio(np, config)
    seconds = audio.size / SAMPLE_RATE
    windows = []
    hook = enc.register_forward_pre_hook(lambda mod, args: windows.append(
        args[0].shape[-1]))
    try:
        pipe.transcribe_long(audio)                      # warm-up
        windows.clear()
        out, counts = counted(torch, dev, mods,
                              lambda: pipe.transcribe_long(audio))
        n_win = len(windows)
        walls = [wall_s(torch, dev, lambda: pipe.transcribe_long(audio))
                 for _ in range(3)]
    finally:
        hook.remove()
    n_frames = 2 * config.n_audio_ctx
    window_s = n_frames * HOP_LENGTH / SAMPLE_RATE
    check(n_win == 3 and windows[:3] == [n_frames] * 3
          and pipe.decode_steps == SAMPLE_LEN - 1,
          f"[long] 3 windows of {n_frames} frames, each decoding "
          f"{SAMPLE_LEN} tokens")
    segs = out["segments"]
    check(set(out) == {"text", "segments", "language"}
          and out["language"] in LANGUAGES and isinstance(out["text"], str)
          and len(segs) <= 3
          and all(abs(s["start"] / window_s - round(s["start"] / window_s))
                  < 1e-9 and s["start"] < s["end"] <= seconds + 1e-9
                  for s in segs),
          "[long] the result: text, a segment a window, the language")
    if on_card:
        check(counts[entry] == n_win * config.n_audio_layer
              and counts["decoder_megakernel"] == n_win * (SAMPLE_LEN - 1)
              and counts[entry] > 0 and counts["decoder_megakernel"] > 0,
              f"[long] {entry} launched {config.n_audio_layer} times and "
              f"the megakernel {SAMPLE_LEN - 1} times a window")
    best = min(walls)
    print(f"[long] {seconds:.1f} s of audio, {n_win} windows, language "
          f"{out['language']}, {len(segs)} segments; best of 3: "
          f"{best * 1e3:.1f} ms ({', '.join(f'{w * 1e3:.1f}' for w in walls)}"
          f"), {seconds / best:.2f} audio s per wall s, "
          f"{best / n_win * 1e3:.1f} ms per window; launches: {entry} "
          f"{counts[entry]}, megakernel {counts['decoder_megakernel']}, "
          f"all {nonzero(counts)}")
    long_e2e = dict(
        seconds=seconds, windows=n_win, language=out["language"],
        segments=len(segs), ms=best * 1e3, ms_runs=[w * 1e3 for w in walls],
        audio_s_per_wall_s=seconds / best, ms_per_window=best / n_win * 1e3,
        detect_language=langs[0], detect_top3=top3, detect_ms=detect_ms,
        detect_prob_sum=total, detect_launches=det_counts,
        launches=nonzero(counts))
    del pipe

    bpipe = whisper_pipeline(built, dm, temperature=1.0, best_of=BEST_OF)
    check(bpipe.n_group == BEST_OF and bpipe._megakernel_blobs(BEST_OF)
          is None, f"[best_of] {BEST_OF} rows an utterance, layer by layer")
    first = []
    calls = recorded_calls(dec, lambda: first.append(
        bpipe.transcribe(mel, seed=SEED)[0]))
    res, bcounts = counted(torch, dev, mods,
                           lambda: bpipe.transcribe(mel, seed=SEED)[0])
    steps = bpipe.decode_steps
    check(res.tokens == first[0].tokens and len(res.tokens) == SAMPLE_LEN
          and all(0 <= t < config.n_vocab for t in res.tokens)
          and np.isfinite(res.avg_logprob),
          f"[best_of] {SAMPLE_LEN} tokens, the same with the same seed")
    if on_card:
        n_calls = n_layer * steps
        check(bcounts["decode_attention_int8"] == n_calls
              and bcounts["decode_attention_bf16"] == n_calls
              and bcounts["decoder_megakernel"] == 0
              and bcounts[entry] == config.n_audio_layer
              and bcounts["decode_attention_int8"] > 0,
              f"[best_of] kernel 1 launched {n_layer} times a step for "
              f"the cross and for the self attention of {BEST_OF} rows, no "
              "megakernel")
    n_check = 8
    with torch.inference_mode():
        lk, lp = (replay_logits(torch, dec, calls, BEST_OF, plain,
                                1 + n_check) for plain in (False, True))
    e_lg = rel_err(lk, lp)
    check(bool(torch.isfinite(lk).all()) and e_lg < 5e-2,
          "[best_of] teacher-forced logits agree with the plain scanned "
          "path (rel 5e-2 of max |logit|)")
    bwalls = [wall_s(torch, dev, lambda: bpipe.transcribe(mel, seed=SEED))
              for _ in range(3)]
    bbest = min(bwalls)
    print(f"[best_of] {BEST_OF} rows, temperature 1.0: {1 / bbest:.4f} utt/s"
          f" ({bbest * 1e3:.1f} ms per utterance, best of 3: "
          f"{', '.join(f'{w * 1e3:.1f}' for w in bwalls)}); {steps} decode "
          f"steps; teacher-forced logits rel err {e_lg:.3e}; launches "
          f"{nonzero(bcounts)}")
    best_e2e = dict(best_of=BEST_OF, temperature=1.0, utt_per_s=1 / bbest,
                    ms_per_utt=bbest * 1e3,
                    ms_runs=[w * 1e3 for w in bwalls], decode_steps=steps,
                    logits_rel_err=e_lg, launches=nonzero(bcounts))
    return long_e2e, counts, best_e2e, bcounts


def santacoder_1b_config():
    """SantaCoder-1B as the JAX package's ``benchmarks/benchmark.py``
    defines it (gpt_bigcode topology, one KV head), bf16, int8 weight-only
    (``--quant woq8``)."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderConfig
    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    return DecoderConfig(vocab_size=49152, hidden_size=2048, num_layers=24,
                         num_heads=16, num_kv_heads=1,
                         max_position_embeddings=2048, dtype="bfloat16",
                         quant_mode=QuantMode.use_weight_only())


def random_decoder_state(torch, np, config, rng):
    """A seeded float state dict in the JAX ``DecoderLMHead`` layout
    (per-layer tensors stacked [n_layer, ...]): LayerNorm weights
    1 + N(0, 0.02), every other tensor N(0, 0.02).  The shapes come from
    the port's float model built on the meta device."""
    import dataclasses

    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    with torch.device("meta"):
        shapes = DecoderLMHead(dataclasses.replace(
            config, quant_mode=QuantMode(0))).state_dict()
    state = {}
    for key, t in shapes.items():
        if key.startswith("blocks.0."):
            key, shape = "blocks." + key[len("blocks.0."):], (
                config.num_layers,) + tuple(t.shape)
        elif key.startswith("blocks."):
            continue
        else:
            shape = tuple(t.shape)
        x = rng.standard_normal(shape, dtype=np.float32) * 0.02
        if key.endswith("layernorm.weight") or key == "ln_f.weight":
            x += 1.0
        state[key] = x
    return state


def decoder_path(torch, np, config=None, device="cuda", label="decoder",
                 float_state=None, kv_scales=None, sampled=False):
    """The decoder-only path on ``device``: ``config`` (default
    SantaCoder-1B, woq8) with random weights from the seed (``float_state``
    where given: :func:`random_decoder_state` of the config, quantised here
    for its recipe; with an int8 KV cache in the config, ``kv_scales`` are
    its per-layer steps), greedy generation of DEC_NEW tokens for DEC_BATCH
    prompts of DEC_PROMPT tokens through the port's ``GenerationSession``,
    as the JAX package's ``benchmarks/benchmark.py`` runs it; the launch
    counts of one such call, the teacher-forced check against the plain path
    and the timings; with ``sampled``, then :func:`sampled_run` on the
    greedy call's prompts (its numbers under ``sampled``).  A smaller ``config`` and the CPU rehearse it without a
    card (the launch counts are then not checked).  Returns (numbers, with
    a float cache the per-layer amax of the cache after the prefill; launch
    counts)."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
        from_jax_state, quantize_state)
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        GenerationSession, ModelConfig, SamplingConfig, bucket_length)

    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    c = config or santacoder_1b_config()
    t0 = time.time()
    if float_state is None:
        float_state = random_decoder_state(torch, np, c,
                                           np.random.default_rng(SEED))
    state = quantize_state(float_state, c)
    kv8 = c.quant_mode.has_int8_kv_cache()
    fp8 = c.quant_mode.has_fp8_kv_cache()
    if kv8 or fp8:
        t = np.asarray(kv_scales, np.float32).reshape(-1, 1)
        state["blocks.attention.kv_orig_quant_scale"] = 1.0 / t
        state["blocks.attention.kv_quant_orig_scale"] = t
    model = from_jax_state(state, c, device=device)
    del state
    want_dtype = (torch.int8 if kv8 else torch.float8_e4m3fn if fp8
                  else getattr(torch, c.dtype))
    check(model.new_kv_cache(1, 4).dtype == want_dtype,
          f"[{label}] the KV cache is {want_dtype}")
    sync()
    print(f"[{label}] {c.num_layers} layers of width {c.hidden_size}, "
          f"{c.num_heads} query heads over {c.num_kv_heads} KV head(s) of "
          f"{c.head_dim}, vocab {c.vocab_size}, {c.quant_mode!r}, built in "
          f"{time.time() - t0:.1f} s")
    mc = ModelConfig(vocab_size=c.vocab_size, num_layers=c.num_layers,
                     num_heads=c.num_heads, hidden_size=c.hidden_size,
                     max_seq_len=c.max_position_embeddings,
                     num_kv_heads=c.num_kv_heads)
    # end_id outside the vocab: every row decodes every token
    sess = GenerationSession(mc, model, SamplingConfig(end_id=-1, pad_id=0))
    rs = np.random.RandomState(0)
    lens = np.full((DEC_BATCH,), DEC_PROMPT, np.int32)

    def prompts():
        return rs.randint(0, c.vocab_size, (DEC_BATCH, DEC_PROMPT)).astype(
            np.int32)

    # warm-up, recording every model call (tokens, cache column, length,
    # start) for the teacher-forced replay below
    calls = []
    hook = model.register_forward_pre_hook(
        lambda mod, args, kwargs: calls.append((args, dict(kwargs))),
        with_kwargs=True)
    try:
        sess.decode(prompts(), lens, max_new_tokens=DEC_NEW)
    finally:
        hook.remove()
    sync()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for m in (da, fa, mk, iq):
        m.reset_launches()
    greedy_ids = prompts()
    tokens, seq_lens, cum = sess.decode(greedy_ids, lens,
                                        max_new_tokens=DEC_NEW)
    counts = {**da.launches, **fa.launches, **mk.launches, **iq.launches}
    peak_gib = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                else float("nan"))
    steps = sess.decode_steps
    print(f"[{label}] {DEC_NEW} tokens for {DEC_BATCH} prompts of "
          f"{DEC_PROMPT} (bucket {bucket_length(DEC_PROMPT)}), {steps} decode "
          f"steps, launches {counts}")
    check(steps == DEC_NEW - 1 and len(calls) == DEC_NEW
          and tokens.shape == (DEC_BATCH, 1, DEC_PROMPT + DEC_NEW)
          and bool((seq_lens == DEC_PROMPT + DEC_NEW).all()),
          f"[{label}] generation decoded {DEC_NEW} tokens for every row")
    check(bool(((tokens >= 0) & (tokens < c.vocab_size)).all())
          and bool(np.isfinite(cum).all()),
          f"[{label}] tokens in range, finite log-probabilities")
    if on_card:
        gqa = "gqa_decode_attention_e4m3" if fp8 else "gqa_decode_attention"
        want = {gqa: c.num_layers * steps}
        what = f"grouped decode kernel ({gqa}) launched {c.num_layers} " \
            "times per decode step"
        if c.quant_mode.is_int4_weight_only():
            # the four linears of each layer, in the prefill and each step
            want["int4_quant_matmul"] = 4 * c.num_layers * (steps + 1)
            what += f", the int4 matmul {4 * c.num_layers} times per call"
        check(all(n == want.get(k, 0) for k, n in counts.items()),
              f"[{label}] {what}, no other kernel")

    # teacher forcing: the kernel path and the plain path replay the
    # recorded calls (prefill and the first steps) on fresh caches
    n_check = 8

    def replay(plain):
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        logits = []
        with ctx, torch.inference_mode():
            cache = model.new_kv_cache(DEC_BATCH, bucket_length(DEC_PROMPT) + DEC_NEW)
            for (tok, _, widx, seq), kw in calls[:1 + n_check]:
                lg, cache = model(tok, cache, widx, seq, **kw)
                logits.append(lg[:, -1])
        return torch.stack(logits)

    lk, lp = replay(False), replay(True)
    kv_amax = None
    if not (kv8 or fp8):
        # the cache after the prefill: its per-layer amax (kv8's scales)
        with torch.inference_mode():
            cache = model.new_kv_cache(DEC_BATCH, bucket_length(DEC_PROMPT))
            (tok, _, widx, seq), kw = calls[0]
            model(tok, cache, widx, seq, **kw)
            kv_amax = cache.float().abs().amax(dim=(1, 2, 3, 4, 5)).cpu() \
                .numpy()
            del cache
    e_lg = rel_err(lk, lp)
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"[{label}] teacher-forced logits (prefill + {n_check} steps), "
          f"kernel path vs plain path: rel err {e_lg:.3e}, argmax agreement "
          f"{agree:.3f}")
    check(bool(torch.isfinite(lk).all()), f"[{label}] logits finite")
    check(e_lg < 5e-2, f"[{label}] teacher-forced logits agree (rel 5e-2 of "
          "max |logit|)")

    step_info = (step_timing(torch, model, replayer(
        model, calls, model.new_kv_cache(
            DEC_BATCH, bucket_length(DEC_PROMPT) + DEC_NEW)), label)
        if on_card else {})
    if on_card:
        step_info.update(prefill_timing(torch, model, replayer(
            model, calls, model.new_kv_cache(
                DEC_BATCH, bucket_length(DEC_PROMPT) + DEC_NEW)), label))

    # end to end: the best of 3 whole decode calls (prefill included), each
    # on prompts of its own, as benchmark.py times them
    times = []
    for ids in [prompts() for _ in range(3)]:
        sync()
        t = time.perf_counter()
        sess.decode(ids, lens, max_new_tokens=DEC_NEW)
        sync()
        times.append(time.perf_counter() - t)
    best = min(times)
    tps = DEC_BATCH * DEC_NEW / best
    print(f"[{label}] end to end: {tps:.2f} tokens/s (batch {DEC_BATCH}, "
          f"{DEC_PROMPT}+{DEC_NEW} tokens, best of 3: {best * 1e3:.1f} ms "
          f"per call); peak memory {peak_gib:.2f} GiB")
    e2e = dict(**step_info, tokens_per_s=tps, ms_per_call=best * 1e3,
               batch=DEC_BATCH, prompt_len=DEC_PROMPT, new_tokens=DEC_NEW,
               num_layers=c.num_layers, peak_gib=peak_gib,
               logits_rel_err=e_lg, logits_argmax_agreement=agree,
               kv_amax_after_prefill=(None if kv_amax is None
                                      else kv_amax.tolist()))
    if sampled:
        e2e["sampled"] = sampled_run(torch, np, sess, model, c, greedy_ids,
                                     lens, tokens, label, on_card)
        print(f"[{label}] sampled beside greedy in this run: tokens/s "
              f"{e2e['sampled']['tokens_per_s']:.2f} vs {tps:.2f}")
    return e2e, counts


def llama_1b_config():
    """LLaMA-1B as the JAX package's ``benchmarks/benchmark.py`` defines it
    (``llama_1b``: 16 layers, d 2048, 16 heads of 128, vocab 32000, ffn
    5504 and ``LLAMA_KW``: RoPE, RMSNorm eps 1e-6, the gated SiLU MLP, no
    biases, a separate LM head), bf16, float weights (``--quant none``)."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderConfig
    return DecoderConfig(
        vocab_size=32000, hidden_size=LLAMA_D, num_layers=LLAMA_LAYERS,
        num_heads=LLAMA_HEADS, ffn_hidden_size=LLAMA_FFN,
        max_position_embeddings=2048, dtype="bfloat16",
        position_embedding="rope", norm="rmsnorm", norm_eps=1e-6,
        hidden_act="silu", gated_mlp=True, attn_bias=False, mlp_bias=False,
        tie_word_embeddings=False)


def random_model(torch, config, device):
    """The port's model of ``config`` on ``device`` with seeded random
    weights made there from a ``torch.Generator`` (norm weights 1 +
    N(0, 0.02), every other tensor N(0, 0.02)): 1.1 B parameters in numpy
    would take about a minute."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    with torch.device(device):
        model = DecoderLMHead(config)
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = torch.randn(p.shape, generator=gen, device=device) * 0.02
            if name.endswith(("layernorm.weight", "ln_f.weight",
                              "ln_embed.weight")):
                x += 1.0
            p.copy_(x)
    return model.eval()


def fp8_model(torch, np, model, config, device, seed=SEED):
    """``model`` (float weights, shared, not copied) with an e4m3 KV
    cache: each layer's scale ``fp8_scales_from_amax`` of the layer's amax
    of the float cache after a prefill of DEC_PROMPT seeded tokens."""
    import dataclasses

    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    from eddie_wang_hackathon2023_tpu_torch.quantization.fp8_layers import \
        fp8_scales_from_amax
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, config.vocab_size, (1, DEC_PROMPT))).long().to(device)
    with torch.inference_mode():
        cache = model.new_kv_cache(1, DEC_PROMPT)
        model(ids, cache, 0, DEC_PROMPT)
        amax = cache.float().abs().amax(dim=(1, 2, 3, 4, 5)).cpu().numpy()
    del cache
    with torch.device("meta"):
        f8 = DecoderLMHead(dataclasses.replace(
            config, quant_mode=config.quant_mode.set_fp8_kv_cache()))
    state = dict(model.state_dict())
    for i, a in enumerate(amax):
        s = torch.tensor([fp8_scales_from_amax(a)], device=device)
        state[f"blocks.{i}.attention.kv_orig_quant_scale"] = 1 / s
        state[f"blocks.{i}.attention.kv_quant_orig_scale"] = s
    f8.load_state_dict(state, assign=True)
    return f8.eval()


def woq8_model(torch, model, config):
    """``model``'s weights quantised int8 weight-only on its device, as
    ``quantize_state`` quantises them (per output channel, amax / 127,
    rounded half to even), in the port's woq8 model."""
    import dataclasses

    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    dev = model.vocab_embedding.weight.device
    with torch.device(dev):
        qmodel = DecoderLMHead(dataclasses.replace(
            config, quant_mode=QuantMode.use_weight_only()))
    fsd = model.state_dict()
    qsd = {}
    with torch.no_grad():
        for key in qmodel.state_dict():
            base = key.rsplit(".", 1)[0]
            if key.endswith(".qweight"):
                w = fsd[base + ".weight"].float()
                if base.endswith("qkv") and base + ".kv_weight" in fsd:
                    # the separate-KV layout joins its K/V columns
                    w = torch.cat([w.reshape(-1, w.shape[-1]),
                                   fsd[base + ".kv_weight"].float().reshape(
                                       -1, w.shape[-1])])
                w = w.reshape(-1, w.shape[-1]).t()            # [in, out]
                amax = w.abs().amax(0)
                s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
                qsd[key] = torch.clamp(torch.round(w / s), -127, 127).to(
                    torch.int8)
                qsd[base + ".per_channel_scale"] = s
            elif not key.endswith(".per_channel_scale"):
                qsd[key] = fsd[key]
    qmodel.load_state_dict(qsd)
    return qmodel.eval()


def session_paths(torch, np, c, runs, label, device, seed, compare=(),
                  prompt_lens=None, want=None):
    """Generation of DEC_NEW tokens for prompts of DEC_PROMPT tokens (or
    of ``prompt_lens`` true lengths, left-padded to DEC_PROMPT; bucketed to
    64) through the port's ``GenerationSession`` for each run (name, model,
    batch) of ``runs``, prompts from ``seed``: the launches of one call
    (``want(name, batch, steps)``: the launch counts the call must show on
    the card, no other kernel; by default one megakernel launch a step at
    batch 1, kernel 1 once a layer a step otherwise), the teacher-forced
    replay of the recorded calls against the plain layer-by-layer path
    (rel 5e-2 of max |logit|), the step's and the prefill's wall and busy
    time, tokens/s (best of 3 calls) and peak memory.  Then for each run
    named in ``compare`` the batch-1 session with
    ``decode_megakernel=False`` on the same weights and prompts: its
    tokens beside the megakernel's (the share of equal positions), the
    megakernel's recorded calls replayed through the layer-by-layer step
    (logits within 5e-2), and both sessions' calls in turns.  Returns
    ({name: numbers}, {name: launch counts})."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        GenerationSession, ModelConfig, SamplingConfig, bucket_length)

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if want is None:
        def want(name, b, steps):
            return ({"decoder_megakernel": steps} if b == 1 else
                    {"decode_attention_bf16": c.num_layers * steps})
    mc = ModelConfig(vocab_size=c.vocab_size, num_layers=c.num_layers,
                     num_heads=c.num_heads, hidden_size=c.hidden_size,
                     max_seq_len=c.max_position_embeddings,
                     num_kv_heads=c.num_kv_heads)
    sc = SamplingConfig(end_id=-1, pad_id=0)
    rs = np.random.RandomState(seed)
    s_cache = -(-(bucket_length(DEC_PROMPT) + DEC_NEW) // 4) * 4

    def lens_of(b):
        return np.asarray(prompt_lens if prompt_lens is not None
                          else [DEC_PROMPT] * b, np.int32)

    def prompts(b):
        return rs.randint(0, c.vocab_size, (b, DEC_PROMPT)).astype(np.int32)

    def record(sess, model, ids, lens):
        calls = []
        hook = model.register_forward_pre_hook(
            lambda mod, args, kwargs: calls.append((args, dict(kwargs))),
            with_kwargs=True)
        try:
            out = sess.decode(ids, lens, max_new_tokens=DEC_NEW)
        finally:
            hook.remove()
        sync()
        return out, calls

    def replay(model, calls, b, plain=False, n=None):
        """Last-position logits of the recorded calls (prefill and steps)
        on a fresh cache: as recorded, or with the plain kernels and
        without the megakernel (the plain layer-by-layer path)."""
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        logits = []
        with ctx, torch.inference_mode():
            cache = model.new_kv_cache(b, s_cache)
            for (tok, _, widx, seq), kw in calls[:n]:
                if plain:
                    kw = {k: v for k, v in kw.items()
                          if k != "megakernel_blobs"}
                lg, cache = model(tok, cache, widx, seq, **kw)
                logits.append(lg[:, -1])
        return torch.stack(logits)

    e2e, counts, sessions = {}, {}, {}
    for name, model, b in runs:
        # the megakernel as the session's default takes it on the card; the
        # CPU rehearsal asks for its plain version
        sess = GenerationSession(mc, model, sc, decode_megakernel=(
            None if on_card else True))
        lens = lens_of(b)
        _, calls = record(sess, model, prompts(b), lens)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for m in (da, fa, mk, iq):
            m.reset_launches()
        ids = prompts(b)
        tokens, seq_lens, cum = sess.decode(ids, lens,
                                            max_new_tokens=DEC_NEW)
        cnt = {**da.launches, **fa.launches, **mk.launches, **iq.launches}
        peak_gib = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                    else float("nan"))
        steps = sess.decode_steps
        counts[name] = cnt
        uses_mk = sess._mk_blobs is not None
        print(f"[{name}] batch {b}, {DEC_NEW} tokens for prompts of "
              f"{[int(n) for n in lens]} (bucket "
              f"{bucket_length(DEC_PROMPT)}), {steps} decode steps, "
              f"megakernel {uses_mk}, launches {cnt}")
        check(steps == DEC_NEW - 1 and len(calls) == DEC_NEW
              and tokens.shape == (b, 1, DEC_PROMPT + DEC_NEW)
              and bool((seq_lens == DEC_PROMPT + DEC_NEW).all())
              and bool(((tokens >= 0) & (tokens < c.vocab_size)).all())
              and bool(np.isfinite(cum).all()),
              f"[{name}] generation decoded {DEC_NEW} tokens, in range, "
              "finite log-probabilities")
        if on_card:
            w = want(name, b, steps)
            check(all(v == w.get(k, 0) for k, v in cnt.items()),
                  f"[{name}] launches {w}, no other kernel")
        lk, lp = replay(model, calls, b), replay(model, calls, b, plain=True)
        e_lg = rel_err(lk, lp)
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        print(f"[{name}] teacher-forced logits (prefill + {DEC_NEW - 1} "
              f"steps), kernel path vs plain layer-by-layer path: rel err "
              f"{e_lg:.3e}, argmax agreement {agree:.3f}")
        check(bool(torch.isfinite(lk).all()) and e_lg < 5e-2,
              f"[{name}] teacher-forced logits agree (rel 5e-2 of max "
              "|logit|)")
        step_info = {}
        if on_card:
            step_info = step_timing(torch, model, replayer(
                model, calls, model.new_kv_cache(b, s_cache)), name)
            step_info.update(prefill_timing(torch, model, replayer(
                model, calls, model.new_kv_cache(b, s_cache)), name))
        times = []
        for run_ids in [prompts(b) for _ in range(3)]:
            sync()
            t = time.perf_counter()
            sess.decode(run_ids, lens, max_new_tokens=DEC_NEW)
            sync()
            times.append(time.perf_counter() - t)
        best = min(times)
        tps = b * DEC_NEW / best
        print(f"[{name}] end to end: {tps:.2f} tokens/s (batch {b}, "
              f"{DEC_PROMPT}+{DEC_NEW} tokens, best of 3: "
              f"{best * 1e3:.1f} ms per call); peak memory {peak_gib:.2f} "
              "GiB")
        e2e[name] = dict(**step_info, tokens_per_s=tps,
                         ms_per_call=best * 1e3, batch=b,
                         prompt_len=DEC_PROMPT, new_tokens=DEC_NEW,
                         num_layers=c.num_layers, megakernel=uses_mk,
                         peak_gib=peak_gib, logits_rel_err=e_lg,
                         logits_argmax_agreement=agree, plain_replay=lp,
                         replayed=lk, calls=calls)
        sessions[name] = (sess, model)

    # the megakernel against the layer-by-layer session on the same
    # weights and prompts
    for name in compare:
        mk_sess, model = sessions[name]
        layer_sess = GenerationSession(mc, model, sc,
                                       decode_megakernel=False)
        lens = lens_of(1)
        ids = prompts(1)
        (tk, _, _), calls = record(mk_sess, model, ids, lens)
        tl, _, _ = layer_sess.decode(ids, lens, max_new_tokens=DEC_NEW)
        same = float((tk[0, 0, DEC_PROMPT:] == tl[0, 0, DEC_PROMPT:]).mean())
        lk = replay(model, calls, 1)
        ll = replay(model, [(a, {k: v for k, v in kw.items()
                                 if k != "megakernel_blobs"})
                            for a, kw in calls], 1)
        e_layer = rel_err(lk, ll)
        print(f"[{name}] megakernel vs layer by layer on the same weights: "
              f"{same:.3f} of the generated positions equal; teacher-forced "
              f"logits rel err {e_layer:.3e}")
        check(e_layer < 5e-2, f"[{name}] the megakernel's teacher-forced "
              "logits within 5e-2 of the layer-by-layer step's")
        turns = {"megakernel": [], "layer": []}
        for which in ("megakernel", "layer", "layer", "megakernel") * 2:
            sess = mk_sess if which == "megakernel" else layer_sess
            sync()
            t = time.perf_counter()
            sess.decode(ids, lens, max_new_tokens=DEC_NEW)
            sync()
            turns[which].append((time.perf_counter() - t) * 1e3)
        print(f"[{name}] whole calls in turns (ms), megakernel / layer by "
              "layer: " + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in zip(
                  turns["megakernel"], turns["layer"])))
        e2e[name].update(equal_tokens_vs_layer=same,
                         logits_rel_err_vs_layer=e_layer,
                         in_turns_ms=turns,
                         tokens_per_s_in_turns={
                             k: DEC_NEW / (min(v) / 1e3)
                             for k, v in turns.items()})
    for v in e2e.values():
        for k in ("plain_replay", "replayed", "calls"):
            v.pop(k)
    del sessions
    return e2e, counts


def llama_path(torch, np, config=None, device="cuda", label="llama"):
    """The llama paths on ``device``: ``config`` (default LLaMA-1B, bf16)
    with random weights made on the device, as ``benchmarks/benchmark.py
    -m llama_1b`` runs it (:func:`session_paths`): at batch 1 with float
    weights (``llama``: each decode step one launch of the megakernel over
    bf16 panels), at batch 1 under woq8 (``llama_woq8``: int8 panels), at
    batch 1 over an e4m3 KV cache (``llama_fp8``: the float weights, each
    decode step one launch of the megakernel's e4m3 self mode;
    :func:`fp8_model`), and at batch DEC_BATCH layer by layer (``llama_b8``: kernel 1 at head dim
    128 once a layer a step); the bf16 batch-1 session also beside the
    same session layer by layer.  A smaller ``config`` and the CPU
    rehearse it (the plain versions; launches not checked).  Returns
    ({path: numbers}, {path: launch counts})."""
    c = config or llama_1b_config()
    t0 = time.time()
    fmodel = random_model(torch, c, device)
    qmodel = woq8_model(torch, fmodel, c)
    f8model = fp8_model(torch, np, fmodel, c, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    print(f"[{label}] {c.num_layers} layers of width {c.hidden_size}, "
          f"{c.num_heads} heads of {c.head_dim}, ffn {c.ffn_hidden_size}, "
          f"vocab {c.vocab_size}, RoPE, RMSNorm, gated SiLU; float and woq8 "
          f"models built on the {torch.device(device).type} in "
          f"{time.time() - t0:.1f} s")
    runs = (("llama", fmodel, 1), ("llama_woq8", qmodel, 1),
            ("llama_fp8", f8model, 1), ("llama_b8", fmodel, DEC_BATCH))
    e2e, counts = session_paths(torch, np, c, runs, label, device, 2,
                                compare=("llama",))
    del fmodel, qmodel, f8model
    return e2e, counts


def santacoder_float_config():
    """SantaCoder-1B (:func:`santacoder_1b_config`) with float weights, bf16
    (``--quant none``)."""
    import dataclasses

    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    return dataclasses.replace(santacoder_1b_config(),
                               quant_mode=QuantMode(0))


def santacoder_path(torch, np, float_state, config=None, device="cuda"):
    """The santacoder paths: ``config`` (default SantaCoder-1B, bf16; 16
    query heads of 128 over one KV head) with the decoder path's seeded
    float state ``float_state``, loaded as it is (``santacoder``: bf16
    panels) and quantised int8 weight-only as the decoder path quantises
    it, on the device (``santacoder_woq8``: :func:`woq8_model` of the fp32
    weights), at batch 1 (:func:`session_paths`): each decode step one
    launch of the megakernel's grouped mode; each beside the same session
    layer by layer (the grouped decode kernel once a layer a step).
    Returns ({path: numbers}, {path: launch counts})."""
    import dataclasses

    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    c = config or santacoder_float_config()
    cq = dataclasses.replace(c, quant_mode=QuantMode.use_weight_only())
    t0 = time.time()
    f32 = from_jax_state(float_state, dataclasses.replace(c, dtype="float32"),
                         device=device)
    with torch.device(device):
        fmodel = DecoderLMHead(c)
    fmodel.load_state_dict(f32.state_dict())
    fmodel.eval()
    qmodel = woq8_model(torch, f32, cq)
    del f32
    print(f"[santacoder] {c.num_layers} layers of width {c.hidden_size}, "
          f"{c.num_heads} query heads over {c.num_kv_heads} KV head(s) of "
          f"{c.head_dim}, vocab {c.vocab_size}; bf16 and woq8 models built "
          f"in {time.time() - t0:.1f} s; eligible for the megakernel: "
          f"{fmodel.megakernel_eligible()}, {qmodel.megakernel_eligible()}")
    check(fmodel.megakernel_eligible() and qmodel.megakernel_eligible(),
          "[santacoder] the MQA model is eligible for the megakernel "
          "(grouped mode)")
    e2e, counts = session_paths(
        torch, np, c, (("santacoder", fmodel, 1),
                       ("santacoder_woq8", qmodel, 1)),
        "santacoder", device, 3, compare=("santacoder", "santacoder_woq8"))
    del fmodel, qmodel
    return e2e, counts


def bloom_560m_config():
    """bloom-560m's widths (HF ``bigscience/bloom-560m`` config.json: 24
    layers, d 1024, 16 heads of 64, ffn 4096, vocab 250880, ALiBi, the
    embedding LayerNorm, eps 1e-5), as the port's ``bloom_config`` maps
    them, bf16."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderConfig
    return DecoderConfig(vocab_size=250880, hidden_size=1024, num_layers=24,
                         num_heads=16, max_position_embeddings=2048,
                         position_embedding="alibi", embedding_norm=True,
                         norm_eps=1e-5, hidden_act="gelu", dtype="bfloat16")


def bloom_path(torch, np, config=None, device="cuda"):
    """The bloom path: ``config`` (default bloom-560m's widths) with random
    weights made on the device, batch DEC_BATCH, DEC_PROMPT + DEC_NEW
    tokens, layer by layer (:func:`session_paths`).  Its attention is plain
    PyTorch with the ALiBi bias, as the JAX package runs it through XLA: no
    TPU kernel runs on this path, so none may launch.  Its teacher-forced
    logits are held against the same weights in fp32 on the device (rel
    5e-2).  Returns (numbers, launch counts)."""
    c = config or bloom_560m_config()
    t0 = time.time()
    model = random_model(torch, c, device)
    print(f"[bloom] {c.num_layers} layers of width {c.hidden_size}, "
          f"{c.num_heads} heads of {c.head_dim}, ffn {c.ffn_hidden_size}, "
          f"vocab {c.vocab_size}, ALiBi, embedding norm; built in "
          f"{time.time() - t0:.1f} s.  No TPU kernel runs on this path: the "
          "attention is plain PyTorch with the ALiBi bias")
    e2e, counts = session_paths(torch, np, c, (("bloom", model, DEC_BATCH),),
                                "bloom", device, 4,
                                want=lambda name, b, steps: {})
    # the same recorded calls in fp32: the bf16 path's logits against them
    e2e["bloom"]["fp32_check"] = fp32_replay_check(
        torch, model, c, device, "bloom")
    del model
    return e2e["bloom"], counts["bloom"]


def chatglm_6b_config():
    """ChatGLM-6B's widths (THUDM/chatglm-6b config.json: 28 layers, d
    4096, 32 heads of 128, inner 16384, vocab 130528, 2048 positions, eps
    1e-5) through the port's ``chatglm6b_config`` (GLM positions, the
    deepnorm residual with alpha sqrt(56), the bidirectional prompt, erf
    GELU, a separate LM head), bf16."""
    import types

    from eddie_wang_hackathon2023_tpu_torch.models.families import \
        chatglm6b_config
    return chatglm6b_config(types.SimpleNamespace(
        vocab_size=GLM_VOCAB, hidden_size=GLM_D, num_layers=GLM_LAYERS,
        num_attention_heads=GLM_HEADS, inner_hidden_size=GLM_FFN,
        max_sequence_length=2048, layernorm_epsilon=1e-5),
        dtype="bfloat16")


def random_state_on(torch, config, device):
    """A seeded random state dict in the JAX ``DecoderLMHead`` layout
    (per-layer tensors stacked [n_layer, ...]) made on ``device`` in the
    config's dtype from a ``torch.Generator`` (LayerNorm weights 1 +
    N(0, 0.02), every other tensor N(0, 0.02)): 6.7 B parameters in numpy
    would take minutes.  The shapes come from the port's model on the meta
    device."""
    from eddie_wang_hackathon2023_tpu_torch._utils import str_dtype_to_torch
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    with torch.device("meta"):
        shapes = DecoderLMHead(config).state_dict()
    dtype = str_dtype_to_torch(config.dtype)
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = {}
    for key, t in shapes.items():
        if key.startswith("blocks.0."):
            key, shape = "blocks." + key[len("blocks.0."):], (
                config.num_layers,) + tuple(t.shape)
        elif key.startswith("blocks."):
            continue
        else:
            shape = tuple(t.shape)
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=dtype) * 0.02
        if key.endswith(("layernorm.weight", "ln_f.weight")):
            x += 1.0
        state[key] = x
    return state


def chatglm_path(torch, np, config=None, device="cuda"):
    """The chatglm path: ``config`` (default ChatGLM-6B's widths) with its
    6.7 B random parameters made on the device in the JAX layout and loaded
    through the port's ``from_jax_state``, batch 8 with prompts of the true
    lengths GLM_PROMPTS (left-padded, bucketed to 64: each row its own GLM
    positions), DEC_NEW new tokens (:func:`session_paths`): the
    bidirectional prefill plain, each decode step kernel 1 at head dim 128
    and 32 heads once a layer; the teacher-forced logits against the same
    calls with kernel 1 replaced by its plain version.  Returns (numbers,
    launch counts)."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    c = config or chatglm_6b_config()
    t0 = time.time()
    state = random_state_on(torch, c, device)
    n_params = sum(v.numel() for v in state.values())
    model = from_jax_state(state, c, device=device)
    del state
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    print(f"[chatglm] {c.num_layers} layers of width {c.hidden_size}, "
          f"{c.num_heads} heads of {c.head_dim}, inner {c.ffn_hidden_size}, "
          f"vocab {c.vocab_size}, GLM positions, deepnorm alpha "
          f"{c.deepnorm_alpha:.4f}, bidirectional prompt; "
          f"{n_params / 1e9:.2f} B parameters made and loaded in "
          f"{time.time() - t0:.1f} s")
    e2e, counts = session_paths(torch, np, c,
                                (("chatglm", model, len(GLM_PROMPTS)),),
                                "chatglm", device, 6, prompt_lens=GLM_PROMPTS)
    del model
    e2e["chatglm"]["parameters"] = n_params
    return e2e["chatglm"], counts["chatglm"]


def fp32_replay_check(torch, model, c, device, label, ids_seed=5):
    """One batch of DEC_BATCH prompts (seeded) through ``model`` and through
    an fp32 copy of its weights on the device, prefill and DEC_NEW - 1
    teacher-forced steps (the bf16 model's greedy tokens fed to both):
    the last-position logits' rel err (5e-2 of max |logit|)."""
    import dataclasses

    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderLMHead
    from eddie_wang_hackathon2023_tpu_torch.runtime import bucket_length
    with torch.device(device):
        ref = DecoderLMHead(dataclasses.replace(c, dtype="float32"))
    ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    ref.eval()
    gen = torch.Generator(device="cpu").manual_seed(ids_seed)
    b, plen = DEC_BATCH, bucket_length(DEC_PROMPT)
    ids = torch.randint(0, c.vocab_size, (b, plen), generator=gen).to(device)
    start = torch.full((b,), plen - DEC_PROMPT, dtype=torch.int32,
                       device=device)
    s_cache = -(-(plen + DEC_NEW) // 4) * 4
    out = {}
    with torch.inference_mode():
        caches = {m: m.new_kv_cache(b, s_cache) for m in (model, ref)}
        lg = {m: [] for m in (model, ref)}
        seq = torch.full((b,), plen, dtype=torch.int32, device=device)
        for m in (model, ref):
            x, caches[m] = m(ids, caches[m], 0, seq, attention_start=start)
            lg[m].append(x[:, -1])
        for j in range(DEC_NEW - 1):
            tok = lg[model][-1].argmax(-1)[:, None]
            seq = torch.full((b,), plen + j + 1, dtype=torch.int32,
                             device=device)
            for m in (model, ref):
                x, caches[m] = m(tok, caches[m], plen + j, seq,
                                 attention_start=start)
                lg[m].append(x[:, -1])
        a, r = torch.stack(lg[model]), torch.stack(lg[ref])
        out = dict(rel_err=rel_err(a, r), argmax_agreement=float(
            (a.argmax(-1) == r.argmax(-1)).float().mean()))
    print(f"[{label}] teacher-forced logits, bf16 model vs its weights in "
          f"fp32: rel err {out['rel_err']:.3e}, argmax agreement "
          f"{out['argmax_agreement']:.3f}")
    check(bool(torch.isfinite(a).all()) and out["rel_err"] < 5e-2,
          f"[{label}] bf16 logits within 5e-2 of the fp32 weights'")
    del ref
    return out


def sampled_config(SamplingConfig, bad=None, stop=None):
    """The decoder path's sampled call: rows 0-1 greedy (temperature 0,
    neutral penalties), the others at temperature 0.8 with their own top-k
    and top-p, repetition penalty 1.1, presence penalty 0.2 and min_length
    4; ``bad`` and ``stop`` words."""
    greedy = [r < SAMPLED_GREEDY_ROWS for r in range(DEC_BATCH)]
    return SamplingConfig(
        end_id=-1, pad_id=0, temperature=[0.0 if g else 0.8 for g in greedy],
        top_k=list(SAMPLED_TOP_K), top_p=list(SAMPLED_TOP_P),
        repetition_penalty=[1.0 if g else 1.1 for g in greedy],
        presence_penalty=[0.0 if g else 0.2 for g in greedy],
        min_length=[0 if g else 4 for g in greedy],
        bad_words_list=bad, stop_words_list=stop)


def word_ends(seq, word, lo, hi):
    """Positions p in [lo, hi) where ``seq`` ends with ``word`` at p."""
    n = len(word)
    return [p for p in range(max(lo, n - 1), hi)
            if list(seq[p - n + 1:p + 1]) == list(word)]


def pick_word(tokens, rows, steps, n, avoid):
    """A word of ``n`` tokens that a row of ``rows`` generated ending at
    one of ``steps`` (after DEC_PROMPT), found nowhere in the sequences
    ``avoid`` (so that it changes none of them)."""
    for r in rows:
        for s in steps:
            w = [int(t) for t in tokens[r, DEC_PROMPT + s - n + 1:
                                        DEC_PROMPT + s + 1]]
            if not any(word_ends(a, w, 0, len(a)) for a in avoid):
                return w
    raise SmokeFailure(f"no word of {n} tokens to pick from rows {rows}")


def sampled_run(torch, np, sess, model, c, ids, lens, greedy, label, on_card):
    """After the greedy call on ``ids`` (its tokens ``greedy``): the same
    prompts with :func:`sampled_config` and SAMPLED_SEED.  The bad words
    come from a call without words (a token of row 6, two tokens of row
    4), the stop words from a call with the bad words (a token of row 3,
    two tokens of row 5), none of them in the greedy rows' sequences.
    Checks the greedy rows against the greedy call, a second call of the
    seed, the bad words (none ends a row's output), the stop words (a row
    is finished after the first it produces: its length ends there and
    the end id follows), the launches (the grouped kernel once a layer and
    step) and the teacher-forced replay; times the call (best of 3).
    Returns its numbers."""
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.runtime import (SamplingConfig,
                                                            bucket_length)
    device = model.vocab_embedding.weight.device

    def call(sc):
        return sess.decode(ids, lens, sc, max_new_tokens=DEC_NEW,
                           seed=SAMPLED_SEED)

    # a word of one or two tokens changes a greedy row only where it
    # ends at one of its generated tokens
    avoid = [greedy[r, 0, DEC_PROMPT - 1:]
             for r in range(SAMPLED_GREEDY_ROWS)]
    free = call(sampled_config(SamplingConfig))[0][:, 0]
    bad = [pick_word(free, [6, 7, 5, 3], range(1, 6), 1, avoid),
           pick_word(free, [4, 5, 2, 6], range(3, 8), 2, avoid)]
    mid = call(sampled_config(SamplingConfig, bad))[0][:, 0]
    stop = [pick_word(mid, [3, 2, 7, 4], range(6, 11), 1, avoid),
            pick_word(mid, [5, 4, 6, 2], range(10, 15), 2, avoid)]
    sc = sampled_config(SamplingConfig, bad, stop)
    calls = recorded_calls(model, lambda: call(sc))
    (tokens, seq_lens, cum), counts = counted(torch, device, [da],
                                              lambda: call(sc))
    again = call(sc)
    steps = sess.decode_steps
    print(f"[{label}] sampled call: bad words {bad}, stop words {stop}, "
          f"lengths {seq_lens[:, 0].tolist()}, {steps} decode steps, "
          f"launches {nonzero(counts)}")
    tok = tokens[:, 0]
    greedy_equal = bool(np.array_equal(tok[:SAMPLED_GREEDY_ROWS],
                                       greedy[:SAMPLED_GREEDY_ROWS, 0]))
    check(greedy_equal, f"[{label}] the sampled call's greedy rows equal the "
          "greedy call's tokens")
    repeatable = all(np.array_equal(a, b) for a, b in zip(
        (tokens, seq_lens, cum), again))
    check(repeatable, f"[{label}] one seed twice gives the same tokens")
    check(not np.array_equal(tok[SAMPLED_GREEDY_ROWS:],
                             greedy[SAMPLED_GREEDY_ROWS:, 0]),
          f"[{label}] the sampled rows are not the greedy tokens")
    end = DEC_PROMPT + DEC_NEW
    # each row's length: one past its first stop word, else every token;
    # the end id after it, tokens in the vocab before it, no bad word
    stops = [min([p for w in stop
                  for p in word_ends(tok[r], w, DEC_PROMPT, end)],
                 default=end - 1) + 1 for r in range(DEC_BATCH)]
    stopped = sum(n < end for n in stops)
    check(seq_lens[:, 0].tolist() == stops
          and all(bool((tok[r, n:] == -1).all()
                       and ((tok[r, :n] >= 0) & (tok[r, :n] < c.vocab_size))
                       .all()) for r, n in enumerate(stops)),
          f"[{label}] {stopped} row(s) finished after their first stop "
          "word, the others decoded every token, all in the vocab")
    check(stopped >= 1 and bool(np.isfinite(cum).all()),
          f"[{label}] at least one row stopped, finite log-probabilities")
    check(not any(word_ends(tok[r], w, DEC_PROMPT, n) for w in bad
                  for r, n in enumerate(stops)),
          f"[{label}] no bad word ends a row's output")
    if on_card:
        check(counts["gqa_decode_attention"] == c.num_layers * steps
              and set(nonzero(counts)) == {"gqa_decode_attention"},
              f"[{label}] the sampled call launched the grouped kernel "
              f"{c.num_layers} times per decode step, no other kernel")

    def replay(plain):
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        logits = []
        with ctx, torch.inference_mode():
            cache = model.new_kv_cache(
                DEC_BATCH, bucket_length(DEC_PROMPT) + DEC_NEW)
            for (t, _, widx, seq), kw in calls:
                lg, cache = model(t, cache, widx, seq, **kw)
                logits.append(lg[:, -1])
        return torch.stack(logits)

    lk, lp = replay(False), replay(True)
    e_lg = rel_err(lk, lp)
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"[{label}] sampled call's teacher-forced logits ({len(calls)} "
          f"calls), kernel path vs plain path: rel err {e_lg:.3e}, argmax "
          f"agreement {agree:.3f}")
    check(e_lg < 5e-2, f"[{label}] the sampled call's teacher-forced logits "
          "agree (rel 5e-2 of max |logit|)")
    best = min(wall_s(torch, device, lambda: call(sc)) for _ in range(3))
    tps = DEC_BATCH * DEC_NEW / best
    print(f"[{label}] sampled call end to end: {tps:.2f} tokens/s (best of "
          f"3: {best * 1e3:.1f} ms per call)")
    return dict(tokens_per_s=tps, ms_per_call=best * 1e3,
                decode_steps=steps, launches=nonzero(counts),
                greedy_rows_equal=greedy_equal, repeatable=repeatable,
                stopped_rows=stopped, bad_words=bad, stop_words=stop,
                logits_rel_err=e_lg, logits_argmax_agreement=agree)


def gpt_350m_config():
    """GPT-350M as the JAX package's ``benchmarks/serve_bench.py:18-21,63-67``
    defines it (24 layers, d 1024, 16 heads, vocab 51200, learned positions
    as many as ``max_seq_len``), bf16, float weights."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderConfig
    return DecoderConfig(vocab_size=51200, hidden_size=1024, num_layers=24,
                         num_heads=16, max_position_embeddings=SERVE_MAX_SEQ,
                         dtype="bfloat16")


def serve_path(torch, np, config=None, device="cuda", label="serve",
               outputs=None):
    """The serve path on ``device``: ``config`` (default GPT-350M) with
    random weights from the seed behind the port's
    ``ContinuousBatchingManager`` (SERVE_SLOTS slots, a block-paged pool of
    SERVE_BLOCK-token blocks, greedy, ``end_id=-1``), SERVE_REQUESTS
    requests of SERVE_PROMPT tokens and SERVE_NEW new ones, as the JAX
    package's ``benchmarks/serve_bench.py --paged`` runs them: a warm-up run
    that records every model call, then three timed runs (the first one
    counted), the teacher-forced check and the tick's timing.  A smaller
    ``config`` and the CPU rehearse it without a card (the launch counts
    are then not checked).  ``outputs``, a dict, receives the warm-up run's
    tokens by request (its prompts are :func:`serve_prompts`).  Returns
    (numbers, launch counts)."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    from eddie_wang_hackathon2023_tpu_torch.ops.paged_attention import \
        PagedCacheState
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        ContinuousBatchingManager, InferenceRequest, SamplingConfig)

    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    c = config or gpt_350m_config()
    t0 = time.time()
    model = from_jax_state(random_decoder_state(
        torch, np, c, np.random.default_rng(SEED)), c, device=device)
    sync()
    print(f"[{label}] {c.num_layers} layers of width {c.hidden_size}, "
          f"{c.num_heads} heads of {c.head_dim}, vocab {c.vocab_size}, "
          f"{c.dtype}, built in {time.time() - t0:.1f} s")
    rs = np.random.RandomState(0)

    def requests():
        return [InferenceRequest(i, rs.randint(0, c.vocab_size, (
            SERVE_PROMPT,)).astype(np.int32), max_new_tokens=SERVE_NEW,
            end_id=-1) for i in range(SERVE_REQUESTS)]

    mgr = ContinuousBatchingManager(
        model, SamplingConfig(end_id=-1, pad_id=0),
        max_batch_size=SERVE_SLOTS, max_seq_len=SERVE_MAX_SEQ, paged=True,
        tokens_per_block=SERVE_BLOCK, device=device)
    print(f"[{label}] {SERVE_SLOTS} slots, a pool of {mgr.num_blocks} blocks "
          f"of {SERVE_BLOCK} tokens, {SERVE_REQUESTS} requests of "
          f"{SERVE_PROMPT}+{SERVE_NEW} tokens")

    def run(queue):
        """One drain of ``queue``, timed as serve_bench.py times it:
        (responses, {request: pull-to-first-response seconds}, wall s).
        Without streaming the first response is the finished one."""
        done, admitted_at, first_tok = [], {}, {}

        def pull(n):
            out = [queue.pop(0) for _ in range(min(n, len(queue)))]
            now = time.time()
            for r in out:
                admitted_at[r.request_id] = now
            return out

        def push(r):
            if r.request_id not in first_tok and r.request_id in admitted_at:
                first_tok[r.request_id] = time.time() - \
                    admitted_at[r.request_id]
            if r.finished:
                done.append(r)

        mgr.get_inference_requests, mgr.send_response = pull, push
        sync()
        t = time.time()
        mgr.run()
        sync()
        return done, first_tok, time.time() - t

    # warm-up, recording every model call (tokens, a copy of the table,
    # write index, length) for the teacher-forced replay below
    calls = []
    hook = model.register_forward_pre_hook(
        lambda mod, args: calls.append(
            (args[0], args[1].block_table.clone(), args[2], args[3])))
    try:
        done, _, _ = run(requests())
    finally:
        hook.remove()
    prefills = sum(tok.shape[1] > 1 for tok, *_ in calls)
    if outputs is not None:
        outputs.update({r.request_id: list(r.output_ids) for r in done})
    check(len(done) == SERVE_REQUESTS and prefills == SERVE_REQUESTS
          and all(len(r.output_ids) == SERVE_NEW
                  and all(0 <= t < c.vocab_size for t in r.output_ids)
                  for r in done),
          f"[{label}] {SERVE_REQUESTS} requests served, {SERVE_NEW} tokens "
          "each, in range")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for m in (da, fa, mk):
        m.reset_launches()
    ticks0 = mgr.decode_ticks
    runs = [run(requests())]
    counts = {**da.launches, **fa.launches, **mk.launches}
    ticks = mgr.decode_ticks - ticks0
    peak_gib = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                else float("nan"))
    print(f"[{label}] {ticks} decode ticks, launches {counts}")
    check(len(runs[0][0]) == SERVE_REQUESTS,
          f"[{label}] the counted run served every request")
    if on_card:
        check(counts["paged_decode_attention"] == c.num_layers * ticks
              and all(n == 0 for k, n in counts.items()
                      if k != "paged_decode_attention"),
              f"[{label}] paged decode kernel launched {c.num_layers} times "
              "per decode tick, no other attention kernel")

    # teacher forcing: the first tick's prefills and the first ticks, on a
    # fresh pool, through the kernel and through its plain version
    n_check = 8

    def replay_call(pool):
        def call(j):
            tok, table, widx, seq = calls[j]
            return model(tok, PagedCacheState(pool, table), widx, seq)
        return call

    def replay(plain):
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        call = replay_call(model.new_paged_pool(mgr.num_blocks, SERVE_BLOCK))
        logits = []
        with ctx, torch.inference_mode():
            for j in range(SERVE_SLOTS + n_check):
                lg, _ = call(j)
                seq = calls[j][3]
                logits.append(lg[:, -1] if lg.shape[1] == 1
                              else lg[:, int(seq[0]) - 1])
        return torch.cat(logits)

    check(all(calls[j][0].shape[1] > 1 for j in range(SERVE_SLOTS))
          and all(calls[j][0].shape == (SERVE_SLOTS, 1) for j in range(
              SERVE_SLOTS, SERVE_SLOTS + n_check)),
          f"[{label}] the recorded run opens with {SERVE_SLOTS} prefills and "
          f"{n_check} ticks")
    lk, lp = replay(False), replay(True)
    e_lg = rel_err(lk, lp)
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"[{label}] teacher-forced logits ({SERVE_SLOTS} prefills + "
          f"{n_check} ticks), kernel path vs plain path: rel err {e_lg:.3e}, "
          f"argmax agreement {agree:.3f}")
    check(bool(torch.isfinite(lk).all()), f"[{label}] logits finite")
    check(e_lg < 5e-2, f"[{label}] teacher-forced logits agree (rel 5e-2 of "
          "max |logit|)")

    step_info = (step_timing(torch, model, replay_call(model.new_paged_pool(
        mgr.num_blocks, SERVE_BLOCK)), label, first=SERVE_SLOTS)
        if on_card else {})

    # serve_bench's metrics, best of 3 timed runs (the counted one first)
    runs += [run(requests()) for _ in range(2)]
    walls = [dt for _, _, dt in runs]
    done, first_tok, dt = min(runs, key=lambda r: r[2])
    toks = sum(len(r.output_ids) for r in done)
    lat = sorted(first_tok.values())
    lat_mean = 1e3 * sum(lat) / len(lat)
    lat_p95 = 1e3 * lat[int(0.95 * (len(lat) - 1))]
    print(f"[{label}] end to end: req_per_s {len(done) / dt:.3f} "
          f"tokens_per_sec {toks / dt:.2f} first_token_ms_mean {lat_mean:.1f} "
          f"p95 {lat_p95:.1f} (best of 3: " + ", ".join(
              f"{w:.3f}" for w in walls) + f" s); peak memory {peak_gib:.2f} "
          "GiB")
    e2e = dict(**step_info, requests=len(done), total_new_tokens=toks,
               decode_ticks=ticks, prefills=prefills, wall_s=dt,
               wall_s_runs=walls, req_per_s=len(done) / dt,
               tokens_per_sec=toks / dt, first_token_ms_mean=lat_mean,
               first_token_ms_p95=lat_p95, num_layers=c.num_layers,
               peak_gib=peak_gib, logits_rel_err=e_lg,
               logits_argmax_agreement=agree)
    return e2e, counts

# the serve_modes path's cells: serve_bench.py's --matrix (dense | paged) x
# (greedy | top-p 0.9 at temperature 0.8, serve_bench.py:107-108), --mixed
# and --steps_per_tick, the paged greedy cell being the serve path; then
# serve_bench.py's --beam 4 (serve_bench.py:108-111: every request of
# SERVE_BEAM beams) on the dense slot cache, on the pool and on the pool
# under mixed admission, and the paged greedy cell over an int8 pool (the
# model with an int8 KV cache, ``kv8``)
SERVE_BEAM = 4
SERVE_MODES = {
    "dense": dict(paged=False),
    "dense_topp": dict(paged=False, top_p=0.9),
    "paged_topp": dict(paged=True, top_p=0.9),
    "paged_mixed": dict(paged=True, mixed_admission=True, chunk_width=16),
    "paged_spt4": dict(paged=True, steps_per_tick=4),
    "dense_beam": dict(paged=False, max_beam_width=SERVE_BEAM,
                       beams=SERVE_BEAM),
    "paged_beam": dict(paged=True, max_beam_width=SERVE_BEAM,
                       beams=SERVE_BEAM),
    "paged_beam_mixed": dict(paged=True, mixed_admission=True,
                             chunk_width=16, max_beam_width=SERVE_BEAM,
                             beams=SERVE_BEAM),
    "paged_kv8": dict(paged=True, kv8=True),
    # the e4m3 cache (fp8_serve_model): the pool, mixed admission over it,
    # beams over it and over the dense slot cache
    "paged_fp8": dict(paged=True, fp8=True),
    "paged_fp8_mixed": dict(paged=True, mixed_admission=True,
                            chunk_width=16, fp8=True),
    "paged_fp8_beam": dict(paged=True, max_beam_width=SERVE_BEAM,
                           beams=SERVE_BEAM, fp8=True),
    "dense_fp8_beam": dict(paged=False, max_beam_width=SERVE_BEAM,
                           beams=SERVE_BEAM, fp8=True),
}
# the recorded calls each cell replays teacher-forced: its opening calls
# (the admissions, or the mixed ticks that feed the prompts) and this many
# decode steps after them
SERVE_MODES_CHECK = 8


def serve_prompts(np, c):
    """The serve path's prompts: SERVE_REQUESTS of SERVE_PROMPT tokens,
    the first draw of RandomState(0), as its warm-up run takes them."""
    rs = np.random.RandomState(0)
    return [rs.randint(0, c.vocab_size, (SERVE_PROMPT,)).astype(np.int32)
            for _ in range(SERVE_REQUESTS)]


def live_logits(torch, logits, widx, seq):
    """The logits [rows, V] of a recorded serving call at each live row's
    last real token: a prompt's at seq - 1; at per-row positions, rows of
    seq > 0 at lane seq - widx - 1 (a decode step's only lane, a window's
    last real one)."""
    if not torch.is_tensor(widx):
        return logits[0, int(seq[0]) - 1][None]
    seq, widx = seq.long(), widx.long()
    lane = (seq - widx - 1).clamp(0, logits.shape[1] - 1)
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, lane][seq > 0]


def kv8_serve_model(torch, np, state, c, model, prompts, device,
                    fp8=False):
    """The serve model with an int8 KV cache (``kv8``): its weights
    (``state``, the JAX layout), each layer's scales from the seed as
    ``tests/test_torch_kv8.py`` makes the decoder-only model's: amax / 127
    of the float model's cache after a prefill of the first SERVE_SLOTS
    prompts.  With ``fp8``, an e4m3 KV cache at the scales
    ``fp8_scales_from_amax`` of the same amax."""
    from eddie_wang_hackathon2023_tpu_torch.quantization.fp8_layers import \
        fp8_scales_from_amax
    import dataclasses

    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    ids = torch.from_numpy(np.stack(prompts[:SERVE_SLOTS])).long().to(
        device)
    cache = model.new_kv_cache(SERVE_SLOTS, SERVE_PROMPT)
    with torch.inference_mode():
        model(ids, cache, 0, SERVE_PROMPT)
    amax = cache.float().abs().amax(dim=(1, 2, 3, 4, 5)).cpu().numpy()
    t = np.asarray([fp8_scales_from_amax(a) for a in amax] if fp8
                   else amax / 127, np.float32).reshape(-1, 1)
    del cache
    cfg = dataclasses.replace(c, quant_mode=(
        c.quant_mode.set_fp8_kv_cache() if fp8
        else c.quant_mode.set_int8_kv_cache()))
    return from_jax_state({**state,
                           "blocks.attention.kv_orig_quant_scale": 1.0 / t,
                           "blocks.attention.kv_quant_orig_scale": t},
                          cfg, device=device)


def serve_modes_path(torch, np, config=None, device="cuda",
                     reference=None):
    """The serve_modes path on ``device``: ``config`` (default GPT-350M)
    with random weights from the seed, built once, behind the port's
    ``ContinuousBatchingManager`` in each cell of SERVE_MODES at the serve
    path's sizes (SERVE_SLOTS slots, SERVE_REQUESTS requests of
    SERVE_PROMPT + SERVE_NEW tokens, max_seq_len SERVE_MAX_SEQ, blocks of
    SERVE_BLOCK, ``end_id=-1``): a warm-up drain of the first wave
    (SERVE_SLOTS requests; a sampled cell's of all of them) that records
    every model call, then one timed drain of every request, each of the
    serve path's prompts and on a manager of its own (one seed).  The beam cells' requests each ask for
    SERVE_BEAM beams of a manager of that width; the kv8 cell's model is
    :func:`kv8_serve_model`, the fp8 cells' its e4m3 twin.  Each cell: every request served with
    SERVE_NEW tokens in range; on the card the launch counts (dense:
    kernel 1, or its beam entry, once a layer a decode step and kernel 2's
    causal mode once a layer an admission; paged: the paged kernel, or its
    beam entry, once a layer a decode step and its window entry once a
    layer a mixed tick; no other attention kernel), the int8 pool of the
    kv8 cell and the native scheduler; the recorded opening calls and
    SERVE_MODES_CHECK steps replayed teacher-forced through the plain
    versions on a fresh cache or pool (rel 5e-2, as the serve path); a
    greedy cell's share of tokens equal to ``reference`` (the serve path's
    paged greedy run, {request: tokens}; printed for every cell), a beam
    cell's share of requests whose best sequence equals the dense_beam
    cell's, a sampled cell's two drains of one seed equal.  Prints
    serve_bench's metrics, the decode step's wall and device-busy time
    and idle share, and peak memory.  Returns ({cell: numbers}, {cell:
    launch counts})."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    from eddie_wang_hackathon2023_tpu_torch.ops.paged_attention import \
        PagedCacheState
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        ContinuousBatchingManager, InferenceRequest, SamplingConfig)

    device = torch.device(device)
    on_card = device.type == "cuda"
    c = config or gpt_350m_config()
    t0 = time.time()
    state = random_decoder_state(torch, np, c, np.random.default_rng(SEED))
    model = from_jax_state(state, c, device=device)
    prompts = serve_prompts(np, c)
    model_kv8 = kv8_serve_model(torch, np, state, c, model, prompts, device)
    model_fp8 = kv8_serve_model(torch, np, state, c, model, prompts, device,
                                fp8=True)
    del state
    sync(torch, device)
    print(f"[serve_modes] {c.num_layers} layers of width {c.hidden_size}, "
          f"built in {time.time() - t0:.1f} s; cells {list(SERVE_MODES)}")
    mods = (da, fa, mk)

    def model_of(opts):
        return (model_kv8 if opts.get("kv8") else model_fp8
                if opts.get("fp8") else model)

    def manager(opts):
        top_p = opts.get("top_p", 0.0)
        sc = (SamplingConfig(end_id=-1, pad_id=0, temperature=0.8,
                             top_p=top_p, random_seed=SEED)
              if top_p > 0 else SamplingConfig(end_id=-1, pad_id=0))
        kw = {k: v for k, v in opts.items()
              if k not in ("top_p", "beams", "kv8", "fp8")}
        return ContinuousBatchingManager(
            model_of(opts), sc,
            max_batch_size=SERVE_SLOTS, max_seq_len=SERVE_MAX_SEQ,
            tokens_per_block=SERVE_BLOCK, device=device, **kw)

    def drain(mgr, beams, n=SERVE_REQUESTS):
        """One drain of the first ``n`` prompts, timed as serve_bench.py
        times it: ({request: tokens}, {request: pull-to-first-response
        s}, wall s).  ``beams``: each request's beam width (1: the
        manager's sampling)."""
        own = (SamplingConfig(end_id=-1, pad_id=0, num_beams=beams)
               if beams > 1 else None)
        queue = [InferenceRequest(i, p, max_new_tokens=SERVE_NEW, end_id=-1,
                                  sampling=own)
                 for i, p in enumerate(prompts[:n])]
        done, admitted_at, first_tok = {}, {}, {}

        def pull(n):
            out = [queue.pop(0) for _ in range(min(n, len(queue)))]
            now = time.time()
            for r in out:
                admitted_at[r.request_id] = now
            return out

        def push(r):
            if r.request_id not in first_tok:
                first_tok[r.request_id] = time.time() - \
                    admitted_at[r.request_id]
            if r.finished:
                done[r.request_id] = list(r.output_ids)

        mgr.get_inference_requests, mgr.send_response = pull, push
        sync(torch, device)
        t = time.time()
        mgr.run()
        sync(torch, device)
        return done, first_tok, time.time() - t

    e2e, counts, beam_ref = {}, {}, None
    for cell, opts in SERVE_MODES.items():
        label = f"serve_modes/{cell}"
        sampled = opts.get("top_p", 0.0) > 0
        beams = opts.get("beams", 1)
        mdl = model_of(opts)
        fp8 = opts.get("fp8", False)
        # warm-up, recording every model call for the replay below
        mgr = manager(opts)
        calls = []

        def record(mod, args, kwargs):
            cache = args[1]
            if isinstance(cache, PagedCacheState):
                where = cache.block_table.clone()
            else:
                # the row of a dense admission (a view), or None
                where = None if cache.shape == mgr.cache.shape else (
                    cache.data_ptr() - mgr.cache.data_ptr()) // (
                    cache.stride(1) * cache.element_size())
            ind = kwargs.get("beam_indirection")
            calls.append((args[0].clone(), where, (
                args[2].clone() if torch.is_tensor(args[2]) else args[2]),
                args[3].clone(), None if ind is None else ind.clone()))
        hook = mdl.register_forward_pre_hook(record, with_kwargs=True)
        try:
            # the first wave of requests holds the calls the replay
            # takes; a sampled cell's warm-up drains all of them, for the
            # check that two drains of one seed agree
            warm, _, _ = drain(mgr, beams,
                               SERVE_REQUESTS if sampled else SERVE_SLOTS)
        finally:
            hook.remove()
        native = type(mgr.sched).__name__
        # the calls before the first decode step: the first wave's
        # admissions, or its mixed ticks
        opening = next(j for j, call in enumerate(calls)
                       if call[0].shape[1] == 1)
        # the timed drain, counted, on a fresh manager of the same seed
        mgr = manager(opts)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for m in mods:
            m.reset_launches()
        done, first_tok, dt = drain(mgr, beams)
        n = {k: v for m in mods for k, v in m.launches.items()}
        counts["serve_" + cell] = n
        peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                else float("nan"))
        check(len(done) == SERVE_REQUESTS
              and all(len(t) == SERVE_NEW and all(0 <= x < c.vocab_size
                                                  for x in t)
                      for t in done.values()),
              f"[{label}] {SERVE_REQUESTS} requests served, {SERVE_NEW} "
              "tokens each, in range")
        L = c.num_layers
        if opts.get("kv8"):
            check(mgr.pool.dtype == torch.int8, f"[{label}] the pool is int8")
        if fp8:
            kv = mgr.pool if opts["paged"] else mgr.cache
            check(kv.dtype == torch.float8_e4m3fn,
                  f"[{label}] the {'pool' if opts['paged'] else 'cache'} is "
                  "e4m3")
        if on_card:
            # the e4m3 modes count apart; an e4m3 slot cache's admission
            # prefill attends over the cache it has written (plain
            # PyTorch, as the JAX layer's XLA), not through kernel 2
            e4 = "_e4m3" if fp8 else ""
            step_kernel = ("beam_decode_attention" + e4 if beams > 1
                           else "decode_attention_bf16")
            if opts["paged"]:
                step_kernel = ("paged_beam_attention" if beams > 1
                               else "paged_decode_attention") + e4
            want = ({step_kernel: L * mgr.decode_steps,
                     "flash_attention_causal": 0 if fp8
                     else L * mgr.prefills}
                    if not opts["paged"] else
                    {step_kernel: L * mgr.decode_steps,
                     "paged_window_attention" + e4: L * mgr.mixed_ticks})
            want = {k: v for k, v in want.items() if v}
            check({k: v for k, v in n.items() if v} == want,
                  f"[{label}] launches {want}, no other attention kernel "
                  f"({mgr.decode_steps} decode steps, {mgr.prefills} "
                  f"admissions, {mgr.mixed_ticks} mixed ticks)")
            check(native == "NativeScheduler",
                  f"[{label}] the native scheduler ran")
        # teacher forcing on a fresh cache or pool, kernels vs plain
        n_calls = opening + SERVE_MODES_CHECK

        def replay(plain):
            fresh = (mdl.new_paged_pool(mgr.num_blocks, SERVE_BLOCK)
                     if opts["paged"] else torch.zeros_like(mgr.cache))
            ctx = plain_kernels() if plain else contextlib.nullcontext()
            out = []
            with ctx, torch.inference_mode():
                for tok, where, widx, seq, ind in calls[:n_calls]:
                    if opts["paged"]:
                        cache = PagedCacheState(fresh, where)
                    else:
                        cache = (fresh if where is None
                                 else fresh[:, where:where + 1])
                    lg, _ = mdl(tok, cache, widx, seq, beam_indirection=ind)
                    out.append(live_logits(torch, lg, widx, seq))
            return torch.cat(out)
        lk = replay(False)
        before = {k: v for m in mods for k, v in m.launches.items()}
        lp = replay(True)
        check(before == {k: v for m in mods for k, v in m.launches.items()},
              f"[{label}] the plain replay launched no kernel")
        e_lg = rel_err(lk, lp)
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        check(bool(torch.isfinite(lk).all()) and e_lg < 5e-2,
              f"[{label}] teacher-forced logits of {n_calls} calls, kernel "
              f"path vs plain: rel err {e_lg:.3e} (< 5e-2), argmax "
              f"agreement {agree:.3f}")
        same = None
        if sampled:
            check(done == warm, f"[{label}] two drains of one seed give "
                  "the same tokens")
        if reference:
            # (serve_bench.py's top-p cell keeps top_k at 1: one token
            # survives, so it samples the greedy token)
            toks = [(a, b) for r in done for a, b in zip(done[r],
                                                         reference[r])]
            same = sum(a == b for a, b in toks) / len(toks)
            print(f"[{label}] tokens equal to the paged greedy run's: "
                  f"{same:.3f}")
        same_beam = None
        if beams > 1:
            beam_ref = beam_ref or done
            same_beam = sum(done[r] == beam_ref[r] for r in done) / len(done)
            print(f"[{label}] requests whose best sequence equals the "
                  f"dense_beam cell's: {same_beam:.3f}")
        step = {}
        if on_card:
            # the decode step (teacher-forced, on a fresh cache or pool
            # after the opening calls)
            fresh = (mdl.new_paged_pool(mgr.num_blocks, SERVE_BLOCK)
                     if opts["paged"] else torch.zeros_like(mgr.cache))

            def call(j):
                tok, where, widx, seq, ind = calls[j]
                cache = (PagedCacheState(fresh, where) if opts["paged"]
                         else fresh if where is None
                         else fresh[:, where:where + 1])
                return mdl(tok, cache, widx, seq, beam_indirection=ind)
            step = step_timing(torch, mdl, call, label, first=opening)
        lat = sorted(first_tok.values())
        toks = sum(len(t) for t in done.values())
        e2e[cell] = dict(
            **step, requests=len(done), total_new_tokens=toks,
            decode_ticks=mgr.decode_ticks, decode_steps=mgr.decode_steps,
            prefills=mgr.prefills, mixed_ticks=mgr.mixed_ticks, wall_s=dt,
            req_per_s=len(done) / dt, tokens_per_sec=toks / dt,
            first_token_ms_mean=1e3 * sum(lat) / len(lat),
            first_token_ms_p95=1e3 * lat[int(0.95 * (len(lat) - 1))],
            peak_gib=peak, logits_rel_err=e_lg,
            logits_argmax_agreement=agree, scheduler=native,
            tokens_equal_to_paged_greedy=same,
            beam_equal_to_dense_beam=same_beam)
        print(f"[{label}] end to end: req_per_s {len(done) / dt:.3f} "
              f"tokens_per_sec {toks / dt:.2f} first_token_ms_mean "
              f"{e2e[cell]['first_token_ms_mean']:.1f} p95 "
              f"{e2e[cell]['first_token_ms_p95']:.1f}; peak memory "
              f"{peak:.2f} GiB; {mgr.decode_ticks} ticks, "
              f"{mgr.decode_steps} decode steps, {mgr.prefills} "
              f"admissions, {mgr.mixed_ticks} mixed ticks; launches "
              f"{ {k: v for k, v in n.items() if v} }")
    return e2e, counts



def gpt_350m_beam_config():
    """GPT-350M as the JAX package's ``benchmarks/beam_bench.py`` defines it
    at its defaults (24 layers, d 1024, 16 heads of 64, vocab 50257, 2048
    positions), bf16, float weights."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
        DecoderConfig
    return DecoderConfig(vocab_size=50257, hidden_size=1024, num_layers=24,
                         num_heads=16, max_position_embeddings=2048,
                         dtype="bfloat16")


def gen_beam_path(torch, np, config=None, device="cuda", label="gen_beam",
                  prompt_len=None, new_tokens=GEN_BEAM_NEW):
    """The decoder-only beam path on ``device``: ``config`` (default
    GPT-350M) with random weights from the seed, beam search with
    GEN_BEAM_WIDTH beams through the port's ``GenerationSession`` (the
    cache read through the indirection table by the beam entry of the
    decode kernel) for one prompt of ``prompt_len`` tokens (default the
    positions less 136, as ``benchmarks/beam_bench.py`` runs it), ``end_id``
    outside the vocab.  As ``beam_bench.py``: a warm-up of both lengths of
    ``new_tokens``, then each timed once, the marginal ms a token their
    difference over the extra tokens.  The launch counts of the long call,
    the teacher-forced replay of its every step against the plain path, the
    step's device-busy time and peak memory.  A smaller ``config`` and the
    CPU rehearse it without a card.  Returns (numbers, launch counts)."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
        from_jax_state, quantize_state)
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        GenerationSession, ModelConfig, SamplingConfig, bucket_length)

    device = torch.device(device)
    on_card = device.type == "cuda"
    c = config or gpt_350m_beam_config()
    beam = GEN_BEAM_WIDTH
    t0 = time.time()
    model = from_jax_state(quantize_state(random_decoder_state(
        torch, np, c, np.random.default_rng(SEED)), c), c, device=device)
    sync(torch, device)
    print(f"[{label}] {c.num_layers} layers of width {c.hidden_size}, "
          f"{c.num_heads} heads of {c.head_dim}, vocab {c.vocab_size}, "
          f"{c.max_position_embeddings} positions, {c.dtype}, built in "
          f"{time.time() - t0:.1f} s")
    mc = ModelConfig(vocab_size=c.vocab_size, num_layers=c.num_layers,
                     num_heads=c.num_heads, hidden_size=c.hidden_size,
                     max_seq_len=c.max_position_embeddings)
    plen = prompt_len or c.max_position_embeddings - 136
    prompt = np.random.RandomState(0).randint(
        0, c.vocab_size, (1, plen)).astype(np.int32)
    lengths = np.asarray([plen])
    sess = GenerationSession(mc, model, SamplingConfig(
        end_id=-1, pad_id=0, num_beams=beam))
    short, long_ = new_tokens

    def run(n):
        return sess.decode(prompt, lengths, max_new_tokens=n)

    run(short)
    calls = recorded_calls(model, lambda: run(long_))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    (tokens, seq_lens, cum), counts = counted(torch, device, [da],
                                              lambda: run(long_))
    peak_gib = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                else float("nan"))
    steps = sess.decode_steps
    bucket = bucket_length(plen)
    s_cache = -(-(bucket + long_) // 4) * 4
    print(f"[{label}] beam {beam}, a prompt of {plen} (bucket {bucket}, "
          f"start {bucket - plen}), {long_} new tokens, a cache of "
          f"{s_cache} columns, {steps} decode steps, launches "
          f"{nonzero(counts)}")
    check(steps == long_ - 1 and len(calls) == long_
          and tokens.shape == (1, beam, plen + long_)
          and bool((seq_lens == plen + long_).all()),
          f"[{label}] beam search decoded {long_} tokens on every beam")
    check(bool(((tokens >= 0) & (tokens < c.vocab_size)).all())
          and bool(np.isfinite(cum).all())
          and bool((np.diff(cum[0]) <= 0).all()),
          f"[{label}] the beams' tokens in the vocab, finite scores in "
          "order")
    if on_card:
        check(counts["beam_decode_attention"] == c.num_layers * steps
              and set(nonzero(counts)) == {"beam_decode_attention"},
              f"[{label}] the beam entry launched {c.num_layers} times per "
              f"decode step ({c.num_layers} x {steps}), no other kernel")

    # teacher forcing: the recorded prefill (batch 1), its cache repeated
    # for the beams as the session repeats it, then every recorded step
    # (its tokens and indirection table), through the kernels and through
    # their plain versions
    def replay(plain, n=len(calls) - 1):
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        with ctx, torch.inference_mode():
            cache = model.new_kv_cache(1, s_cache)
            (tok, _, widx, seq), kw = calls[0]
            lg, cache = model(tok, cache, widx, seq, **kw)
            logits = [lg[:, -1].repeat_interleave(beam, dim=0)]
            cache = cache.repeat_interleave(beam, dim=1)
            for (tok, _, widx, seq), kw in calls[1:1 + n]:
                lg, cache = model(tok, cache, widx, seq, **kw)
                logits.append(lg[:, -1])
        return torch.stack(logits), cache

    # the (row, column) pairs the last step's table points at over the
    # columns it reads (the prompt's and the generated ones before the
    # step's own): after the prefill only beam 0 is live, so every beam
    # reads the prompt's columns from one row
    ind_last = calls[-1][1]["beam_indirection"]
    lo, hi = bucket - plen, bucket + long_ - 2
    pair_share = table_pairs(torch, ind_last, lo, hi) / (beam * (hi - lo))
    prompt_rows = torch.unique(ind_last[..., lo:bucket]).tolist()
    print(f"[{label}] the last step's table points at {pair_share:.3f} of "
          f"the (row, column) pairs; the prompt's columns at rows "
          f"{prompt_rows}")
    (lk, cache), (lp, _) = replay(False), replay(True)
    e_lg = rel_err(lk, lp)
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"[{label}] teacher-forced logits (prefill + {len(calls) - 1} "
          f"steps), kernel path vs plain path: rel err {e_lg:.3e}, argmax "
          f"agreement {agree:.3f}")
    check(bool(torch.isfinite(lk).all()), f"[{label}] logits finite")
    check(e_lg < 5e-2, f"[{label}] teacher-forced logits agree (rel 5e-2 of "
          "max |logit|)")
    step_info = (step_timing(torch, model, replayer(model, calls[1:], cache),
                             label, first=0) if on_card else {})
    del cache, calls

    # beam_bench.py's timing: each length once after the warm-up
    t_short = wall_s(torch, device, lambda: run(short))
    t_long = wall_s(torch, device, lambda: run(long_))
    marginal = (t_long - t_short) / (long_ - short) * 1e3
    print(f"[{label}] end to end: {short} tokens {t_short * 1e3:.1f} ms, "
          f"{long_} tokens {t_long * 1e3:.1f} ms, marginal "
          f"{marginal:.3f} ms per token; peak memory {peak_gib:.2f} GiB")

    # beam_bench.py's other mode: the whole cache gathered by parent every
    # step (use_cache_indirection=False), kernel 1 serving the step; timed
    # the same way, its tokens and scores beside the indirection run's
    gsess = GenerationSession(mc, model, SamplingConfig(
        end_id=-1, pad_id=0, num_beams=beam), use_cache_indirection=False)

    def run_gather(n):
        return gsess.decode(prompt, lengths, max_new_tokens=n)

    run_gather(short)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    (g_tokens, g_lens, g_cum), g_counts = counted(
        torch, device, [da], lambda: run_gather(long_))
    g_peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
              else float("nan"))
    g_short = wall_s(torch, device, lambda: run_gather(short))
    g_long = wall_s(torch, device, lambda: run_gather(long_))
    g_marginal = (g_long - g_short) / (long_ - short) * 1e3
    gen = np.s_[:, :, plen:]
    same = float((g_tokens[gen] == tokens[gen]).mean())
    print(f"[{label}] gather mode: {short} tokens {g_short * 1e3:.1f} ms, "
          f"{long_} tokens {g_long * 1e3:.1f} ms, marginal "
          f"{g_marginal:.3f} ms per token (indirection {marginal:.3f}); "
          f"peak memory {g_peak:.2f} GiB; launches {nonzero(g_counts)}; "
          f"generated tokens equal to the indirection run's: {same:.3f}, "
          f"cum log-probs {g_cum[0].tolist()} vs {cum[0].tolist()}")
    check(g_tokens.shape == tokens.shape
          and bool((g_lens == seq_lens).all())
          and bool(((g_tokens >= 0) & (g_tokens < c.vocab_size)).all())
          and bool(np.isfinite(g_cum).all()),
          f"[{label}] gather mode decoded {long_} tokens on every beam")
    # kernel 1 and the beam entry sum in other orders, so a near tie
    # between candidates may go the other way (the tokens then part); the
    # beams found score the same within 1e-3
    check(bool(np.allclose(g_cum, cum, rtol=1e-3, atol=0.0)),
          f"[{label}] gather mode's beam scores equal the indirection "
          "run's (rel 1e-3)")
    if on_card:
        check(nonzero(g_counts) == {"decode_attention_bf16":
                                    c.num_layers * gsess.decode_steps},
              f"[{label}] gather mode launched kernel 1 {c.num_layers} "
              "times per decode step, no other kernel")
    # beam_bench.py's --beam 1 case on the same prompt: greedy at batch 1,
    # through the megakernel where the model is eligible (its cache of
    # s_cache columns takes more than 8 attention slices), beside the
    # layer-by-layer session; the megakernel's calls replayed
    # teacher-forced through the layer-by-layer step
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    g1 = GenerationSession(mc, model, SamplingConfig(end_id=-1, pad_id=0),
                           decode_megakernel=None if on_card else True)
    g1_calls = recorded_calls(model, lambda: g1.decode(
        prompt, lengths, max_new_tokens=long_))
    (g1_tokens, _, _), g1_counts = counted(
        torch, device, [mk], lambda: g1.decode(prompt, lengths,
                                               max_new_tokens=long_))
    layer_tokens, _, _ = GenerationSession(
        mc, model, SamplingConfig(end_id=-1, pad_id=0),
        decode_megakernel=False).decode(prompt, lengths,
                                        max_new_tokens=long_)
    g1_mk = g1._mk_blobs is not None
    g1_same = float((g1_tokens[gen] == layer_tokens[gen]).mean())
    with torch.inference_mode():
        g1_logits = []
        for strip in (False, True):
            cache = model.new_kv_cache(1, s_cache)
            out = []
            for (tok, _, widx, seq), kw in g1_calls:
                if strip:
                    kw = {k: v for k, v in kw.items()
                          if k != "megakernel_blobs"}
                lg, cache = model(tok, cache, widx, seq, **kw)
                out.append(lg[:, -1])
            g1_logits.append(torch.stack(out))
        del cache
    g1_err = rel_err(*g1_logits)
    print(f"[{label}] greedy at batch 1, the same prompt ({s_cache} cache "
          f"columns, {-(-s_cache // mk.ATTN_SPLIT)} attention slices): "
          f"megakernel {g1_mk}, launches {nonzero(g1_counts)}; generated "
          f"tokens equal to the layer-by-layer session's: {g1_same:.3f}; "
          f"teacher-forced logits rel err {g1_err:.3e}")
    check(g1_mk == model.megakernel_eligible(),
          f"[{label}] batch 1 takes the megakernel where the model is "
          "eligible")
    check(bool(torch.isfinite(g1_logits[0]).all()) and g1_err < 5e-2,
          f"[{label}] batch 1's teacher-forced logits within 5e-2 of the "
          "layer-by-layer step's")
    if on_card:
        check(nonzero(g1_counts) == ({"decoder_megakernel": g1.decode_steps}
                                     if g1_mk else {}),
              f"[{label}] batch 1 launched the megakernel once a decode "
              "step")
    del g1, g1_calls, g1_logits
    e2e = dict(**step_info, marginal_ms_per_token=marginal,
               short_ms=t_short * 1e3, long_ms=t_long * 1e3,
               gather=dict(marginal_ms_per_token=g_marginal,
                           short_ms=g_short * 1e3, long_ms=g_long * 1e3,
                           peak_gib=g_peak, launches=nonzero(g_counts),
                           tokens_equal_share=same,
                           cum_log_probs=g_cum[0].tolist()),
               new_tokens=list(new_tokens), beam=beam, prompt_len=plen,
               cache_columns=s_cache, num_layers=c.num_layers,
               decode_steps=steps, peak_gib=peak_gib, logits_rel_err=e_lg,
               logits_argmax_agreement=agree, table_pair_share=pair_share,
               cum_log_probs=cum[0].tolist(),
               greedy_b1=dict(megakernel=g1_mk,
                              launches=nonzero(g1_counts),
                              tokens_equal_share=g1_same,
                              logits_rel_err_vs_layer=g1_err))
    return e2e, counts


def probes_path(torch, device="cuda", panels=None):
    """The probes path: the three ``tools/megakernel_probe*.py`` scripts'
    ``main(["--device", device])``, run in this process in order; each must
    return 0 (its kernels within tolerance of their references).  They
    time with this module's helpers.  ``panels`` cuts the scripts' 128
    panels (the CPU rehearsal)."""
    import importlib.util
    import types
    mp = probe_kernels()
    helpers = types.SimpleNamespace(
        time_ms=time_ms, bound=bound,
        PEAK_FP32_CUDA_CORES=PEAK_FP32_CUDA_CORES)
    t = time.perf_counter()
    for name in PROBE_SCRIPTS:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "tools", f"{name}.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        if panels is not None:
            script.NP = panels
        check(script.main(["--device", device], smoke=helpers) == 0,
              f"tools/{name}.py --device {device} exits 0")
    return dict(wall_s=time.perf_counter() - t), dict(mp.launches)


def paths(torch, np, results, config=None, device="cuda",
          decoder_config=None, serve_config=None, gen_beam_config=None,
          llama_config=None, bloom_config=None, chatglm_config=None):
    """The main path (full depth, bench recipe, megakernel decode), then
    the custom path on the main path's model, then the kv8 paths on it
    (:func:`kv8_paths`), then the detect, long and best_of paths on it
    (:func:`long_paths`), then the scanned path
    (decode_megakernel=False, recipe without sqenc, depth cut to
    SCANNED_DEPTH layers to keep the run short), then the beam path
    (depth cut as the scanned path's, recipe without sqenc, BEAM_SIZE
    beams), all with the
    Whisper ``config``; then the decoder path with ``decoder_config``
    (default SantaCoder-1B) under its recipe, under int4 weight-only and,
    cut to KV8_DEC_DEPTH layers, under its recipe with an int8 KV cache
    (the woq8 run followed by its sampled call), the santacoder paths on
    the same float state in bf16 (``decoder_config`` without its
    quantisation, :func:`santacoder_path`), the llama paths with
    ``llama_config`` (default LLaMA-1B; :func:`llama_path`), the bloom path
    with ``bloom_config`` (default bloom-560m's widths), the chatglm path
    with ``chatglm_config`` (default ChatGLM-6B's widths), the serve path and
    the serve_modes path with ``serve_config`` (default GPT-350M; the
    dense slot cache, sampling, mixed admission and steps_per_tick, each
    greedy cell beside the serve path's tokens) and the gen_beam path with
    ``gen_beam_config`` (default GPT-350M at beam_bench.py's widths).
    Each kernel's launches come from the path that drives it, and must be
    above 0 there on the card."""
    import dataclasses

    from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
        BENCH_RECIPE, whisper_config)
    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    from eddie_wang_hackathon2023_tpu_torch.quantization.fp8_layers import \
        fp8_scales_from_amax
    on_card = torch.device(device).type == "cuda"
    # each path's wall seconds, for the script's time limit
    laps, t_lap = {}, [time.time()]

    def lap(name):
        laps[name] = round(time.time() - t_lap[0], 1)
        t_lap[0] = time.time()
    config = config or whisper_config("large-v2", dtype="bfloat16")
    # on the card the pipeline's default takes the megakernel; the CPU
    # rehearsal asks for it (its plain version)
    built = build_whisper(torch, np, config, device, BENCH_RECIPE, "main")
    main_e2e, main_counts = main_path(
        torch, np, device=device, decode_megakernel=None if on_card else True,
        label="main", built=built)
    lap("main")
    custom_e2e, custom_counts = custom_path(torch, np, built, device=device)
    lap("custom")
    kv8_e2e, kv8_counts, kv8s_e2e, kv8s_counts = kv8_paths(torch, np, built,
                                                           device=device)
    lap("kv8")
    fp8_e2e, fp8_counts = fp8_path(torch, np, built, kv8_e2e["self_kv_amax"],
                                   main_e2e, device=device)
    lap("fp8")
    print("[kv8] beside main in this run: " + ", ".join(
        f"{k} {kv8_e2e.get(k)} vs {main_e2e.get(k)}"
        for k in ("utt_per_s", "slope_ms_per_token", "decoder_step_ms",
                  "device_busy_ms_per_step", "device_idle_share",
                  "peak_gib")))
    long_e2e, long_counts, best_e2e, best_counts = long_paths(
        torch, np, built, device=device)
    lap("long")
    var_e2e, var_counts = whisper_variant_paths(torch, np, built, main_e2e,
                                                device=device)
    lap("woq4_float")
    del built
    cut = dataclasses.replace(
        config, n_audio_layer=min(SCANNED_DEPTH, config.n_audio_layer),
        n_text_layer=min(SCANNED_DEPTH, config.n_text_layer))
    print(f"[scanned] the layer-by-layer path runs at depth "
          f"{cut.n_audio_layer}+{cut.n_text_layer} (widths unchanged)")
    scan_built = build_whisper(torch, np, cut, device, SCANNED_RECIPE,
                               "scanned")
    scan_e2e, scan_counts = main_path(
        torch, np, device=device, decode_megakernel=False, label="scanned",
        built=scan_built)
    lap("scanned")
    # the same model with an e4m3 self cache, layer by layer: kernel 1's
    # self calls over it (the scales from its own calibration)
    fp8s_e2e, fp8s_counts = main_path(
        torch, np, device=device, decode_megakernel=False,
        label="fp8_scanned", slope=False, built=fp8_built(
            torch, np, scan_built, self_kv_amax(torch, np, scan_built,
                                                device)))
    del scan_built
    lap("fp8_scanned")
    woq4s_e2e, woq4s_counts = woq4_scanned_path(torch, np, cut, device)
    lap("woq4_scanned")
    # the megakernel asked for as on the main path: at batch BEAM_SIZE the
    # pipeline must not take it; the depth cut as the scanned path's, to
    # keep the script near ten minutes
    print(f"[beam] the beam path runs at depth "
          f"{cut.n_audio_layer}+{cut.n_text_layer} (widths unchanged)")
    beam_e2e, beam_counts = main_path(
        torch, np, config=cut, device=device,
        decode_megakernel=None if on_card else True, recipe=SCANNED_RECIPE,
        label="beam", beam=BEAM_SIZE)
    lap("beam")
    # the woq8 and woq4 decoder paths quantise one seeded float state
    dec_cfg = decoder_config or santacoder_1b_config()
    float_state = random_decoder_state(torch, np, dec_cfg,
                                       np.random.default_rng(SEED))
    dec_e2e, dec_counts = decoder_path(torch, np, config=dec_cfg,
                                       device=device, float_state=float_state,
                                       sampled=True)
    lap("decoder")
    woq4_e2e, woq4_counts = decoder_path(
        torch, np, config=dataclasses.replace(
            dec_cfg, quant_mode=QuantMode.use_weight_only(True)),
        device=device, label="decoder_woq4", float_state=float_state)
    lap("decoder_woq4")
    # woq8 with the int8 KV cache, at SantaCoder-1B's widths cut to
    # KV8_DEC_DEPTH layers: the first layers of the same weights, each
    # layer's step the woq8 run's cache amax after its prefill / 127
    depth = min(KV8_DEC_DEPTH, dec_cfg.num_layers)
    kv8_dec_e2e, kv8_dec_counts = decoder_path(
        torch, np, config=dataclasses.replace(
            dec_cfg, num_layers=depth,
            quant_mode=dec_cfg.quant_mode.set_int8_kv_cache()),
        device=device, label="decoder_kv8", float_state={
            k: v[:depth] if k.startswith("blocks.") else v
            for k, v in float_state.items()},
        kv_scales=np.asarray(dec_e2e["kv_amax_after_prefill"][:depth],
                             np.float32) / 127)
    lap("decoder_kv8")
    # the same with an e4m3 KV cache: each layer's scale
    # fp8_scales_from_amax of the same amax; the grouped kernel reads it
    fp8_dec_e2e, fp8_dec_counts = decoder_path(
        torch, np, config=dataclasses.replace(
            dec_cfg, num_layers=depth,
            quant_mode=dec_cfg.quant_mode.set_fp8_kv_cache()),
        device=device, label="decoder_fp8", float_state={
            k: v[:depth] if k.startswith("blocks.") else v
            for k, v in float_state.items()},
        kv_scales=[fp8_scales_from_amax(a)
                   for a in dec_e2e["kv_amax_after_prefill"][:depth]])
    lap("decoder_fp8")
    santa_e2e, santa_counts = santacoder_path(
        torch, np, float_state, config=dataclasses.replace(
            dec_cfg, quant_mode=QuantMode(0)), device=device)
    lap("santacoder")
    del float_state
    print("[decoder_woq4] beside woq8 in this run: " + ", ".join(
        f"{k} {woq4_e2e.get(k)} vs {dec_e2e.get(k)}"
        for k in ("tokens_per_s", "decoder_step_ms",
                  "device_busy_ms_per_step", "device_idle_share",
                  "peak_gib")))
    llama_e2e, llama_counts = llama_path(torch, np, config=llama_config,
                                         device=device)
    lap("llama")
    bloom_e2e, bloom_counts = bloom_path(torch, np, config=bloom_config,
                                         device=device)
    lap("bloom")
    glm_e2e, glm_counts = chatglm_path(torch, np, config=chatglm_config,
                                       device=device)
    lap("chatglm")
    serve_tokens = {}
    serve_e2e, serve_counts = serve_path(torch, np, config=serve_config,
                                         device=device, outputs=serve_tokens)
    lap("serve")
    modes_e2e, modes_counts = serve_modes_path(
        torch, np, config=serve_config, device=device,
        reference=serve_tokens)
    lap("serve_modes")
    gen_beam_e2e, gen_beam_counts = gen_beam_path(torch, np,
                                                  config=gen_beam_config,
                                                  device=device)
    lap("gen_beam")
    probe_kernels().reset_launches()
    probes_e2e, probes_counts = probes_path(torch, device=device)
    lap("probes")
    print(f"seconds a path: {laps}")
    counts = dict(main=main_counts, custom=custom_counts,
                  scanned=scan_counts, beam=beam_counts, decoder=dec_counts,
                  decoder_woq4=woq4_counts, serve=serve_counts,
                  probes=probes_counts, kv8=kv8_counts,
                  kv8_scanned=kv8s_counts, decoder_kv8=kv8_dec_counts,
                  long=long_counts, best_of=best_counts,
                  gen_beam=gen_beam_counts, bloom=bloom_counts,
                  chatglm=glm_counts, woq4_scanned=woq4s_counts,
                  fp8=fp8_counts, fp8_scanned=fp8s_counts,
                  decoder_fp8=fp8_dec_counts,
                  **var_counts, **llama_counts, **santa_counts,
                  **modes_counts)
    for name in KERNELS:
        n = counts[PATH_OF[name]][COUNTER_OF.get(name, name)]
        results.setdefault(name, {}).update(launches=n, path=PATH_OF[name])
        if on_card:
            check(n > 0, f"{name} launched on the {PATH_OF[name]} path")
    if on_card:
        check(not any(bloom_counts.values()), "the bloom path launched no "
              "kernel: no TPU kernel runs on it (ALiBi attention in plain "
              "PyTorch, as the JAX package runs it through XLA)")
    return dict(main=main_e2e, custom=custom_e2e, scanned=scan_e2e,
                beam=beam_e2e, decoder=dec_e2e, decoder_woq4=woq4_e2e,
                serve=serve_e2e, probes=probes_e2e, kv8=kv8_e2e,
                kv8_scanned=kv8s_e2e, decoder_kv8=kv8_dec_e2e,
                long=long_e2e, best_of=best_e2e, gen_beam=gen_beam_e2e,
                bloom=bloom_e2e, chatglm=glm_e2e, woq4_scanned=woq4s_e2e,
                fp8=fp8_e2e, fp8_scanned=fp8s_e2e, decoder_fp8=fp8_dec_e2e,
                **var_e2e, **llama_e2e, **santa_e2e,
                serve_modes=modes_e2e, path_seconds=laps)


def example_run():
    """``examples/custom_kernel_torch/run.py --device cuda``, called in this
    process: its output must end with its OK line."""
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        "custom_kernel_example",
        os.path.join(HERE, "examples", "custom_kernel_torch", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            run.main(["--device", "cuda"])
    finally:
        print(buf.getvalue(), end="")
    out = buf.getvalue()
    check(out.rstrip().endswith("custom kernel example OK"),
          "examples/custom_kernel_torch/run.py --device cuda ends with its "
          "OK line")


def main():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ is not beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")

    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    example_kernel()        # registers the user kernel's source to build
    probe_kernels()         # and the probes' source
    t0 = time.time()
    logs = _build.build()
    print(f"kernels built in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    results = {}
    try:
        t = time.time()
        kernel_phases(torch, results)
        print(f"kernel checks took {time.time() - t:.1f} s")
        if "--kernels-only" in sys.argv[1:]:
            print(json.dumps(results))
            return 0
        e2e = paths(torch, np, results)
        example_run()
    except SmokeFailure as e:
        print(f"[FAIL] {e}", file=sys.stderr)
        return 1
    kernels = [dict(name=name, **KERNELS[name], **results[name])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels, "end_to_end": e2e,
                      "nvidia_smi": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
