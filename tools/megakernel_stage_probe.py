#!/usr/bin/env python3
"""Where the whole-step decode megakernel's time goes, stage by stage, on
one NVIDIA GPU.

    python3 tools/megakernel_stage_probe.py   # from the root of a checkout

Builds a copy of ``eddie_wang_hackathon2023_tpu_torch/csrc/decoder_layer.cu``
into ``build/probe/`` in which thread 0 of block 0 stamps ``%globaltimer``
(ns, one clock for every SM) and ``clock64()`` at the kernel's start, just
before and just after each grid barrier (``grid_sync``: 8 a layer) and at
its end; the kernel in the package is left as it is.  Runs one decode step
at Whisper large-v2 width and depth (32 layers, d 1280, 20 heads of 64,
bf16 self cache of 448 at sequence 44, int8 cross cache of 1500) with the
seeded random weights of ``chip_smoke.py`` (``random_blobs``) through the
port's ``fused_decoder_stack``, and prints for each stage of a layer,
summed over the 32 layers: block 0's work (from the previous barrier's
exit to this barrier's entry), block 0's wait at the barrier (entry to
exit), and the stage's GEMV bytes (and cache bytes, for attention) over
block 0's work time.  Thread 0 of every block also stamps ``%globaltimer``
at the kernel's start and on entry to and exit from every barrier, which
splits block 0's wait into the time until the last block arrives (load
imbalance) and the barrier's own latency (the last arrival to block 0's
release), and gives each stage's span (the first block's exit from the
previous barrier to the last block's entry) and its bytes over that span.
The stamps' total must lie within 10% of the step timed by CUDA events
(behind a spin, as ``chip_smoke.py`` times kernels).
"""
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

MAX_STAMPS = 1024
MAX_BARRIERS = 512       # per block: 8 a layer
MAX_BLOCKS = 1024
STAMP_DEFS = f"""
#define EWT_MAX_STAMPS {MAX_STAMPS}
#define EWT_MAX_BARRIERS {MAX_BARRIERS}
#define EWT_MAX_BLOCKS {MAX_BLOCKS}
__device__ unsigned long long g_st[2 * EWT_MAX_STAMPS];
__device__ int g_n;
#define STAMP() do {{                                                     \\
  if (threadIdx.x == 0 && blockIdx.x == 0 && g_n < EWT_MAX_STAMPS) {{    \\
    unsigned long long t_;                                              \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \\
    g_st[2 * g_n] = t_;                                                 \\
    g_st[2 * g_n + 1] = (unsigned long long)clock64();                  \\
    ++g_n;                                                              \\
  }} }} while (0)
// every block: its start, and its entry (side 0) to and exit (side 1) from
// each barrier, at [2 * barrier + side][block]
__device__ unsigned long long g_bt[2 * EWT_MAX_BARRIERS * EWT_MAX_BLOCKS];
__device__ unsigned long long g_b0[EWT_MAX_BLOCKS];
__device__ int g_bn[EWT_MAX_BLOCKS];
#define BSTAMP(side) do {{                                                 \\
  if (threadIdx.x == 0 && blockIdx.x < EWT_MAX_BLOCKS) {{                \\
    const int n_ = g_bn[blockIdx.x];                                    \\
    unsigned long long t_;                                              \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \\
    if ((side) < 0) g_b0[blockIdx.x] = t_;                              \\
    else if (n_ < EWT_MAX_BARRIERS) {{                                   \\
      g_bt[(2 * n_ + (side)) * EWT_MAX_BLOCKS + blockIdx.x] = t_;       \\
      if (side) g_bn[blockIdx.x] = n_ + 1;                              \\
    }}                                                                   \\
  }} }} while (0)
"""
STAMP_READERS = """
extern "C" int reset_stamps() {
  int z = 0;
  cudaError_t e = cudaMemcpyToSymbol(g_n, &z, sizeof(z));
  void* bn = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&bn, g_bn);
  if (e == cudaSuccess) e = cudaMemset(bn, 0, sizeof(g_bn));
  return (int)e;
}
extern "C" int read_block_stamps(unsigned long long* bt,
                                 unsigned long long* b0, int* bn) {
  cudaError_t e = cudaMemcpyFromSymbol(bn, g_bn, sizeof(g_bn));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(b0, g_b0, sizeof(g_b0));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(bt, g_bt, sizeof(g_bt));
  return (int)e;
}
extern "C" int read_stamps(unsigned long long* h, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_n, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(h, g_st, sizeof(g_st));
}
"""
# the stages of a layer, each ending at its grid barrier (the comments of
# csrc/decoder_layer.cu's kernel), and the weight panels each streams
STAGES = ("qkv", "self-attention slices", "combine + out-proj", "cross-q",
          "cross slices", "combine + cross-out", "fc1", "fc2")


def stage_panels(nf: int):
    return (3, 0, 1, 1, 0, 1, nf, nf)


def stamped_source(src: str) -> str:
    """``src`` (decoder_layer.cu) with block 0's stamp (``STAMP``) at the
    kernel's start, on entry to and exit from ``grid_sync`` and at the
    kernel's end, every block's (``BSTAMP``) at its start and on entry to
    and exit from ``grid_sync``, and the C entries ``reset_stamps``,
    ``read_stamps`` and ``read_block_stamps``."""
    def insert(text, anchor, stamp_after, start=0):
        i = text.index(anchor, start) + len(anchor)
        return text[:i] + stamp_after + text[i:]

    head = "__device__ void grid_sync(unsigned int* bar) {\n"
    src = insert(src, head, "  STAMP();\n  BSTAMP(0);\n")
    src = insert(src, "  __syncthreads();\n", "  STAMP();\n  BSTAMP(1);\n",
                 src.index("  __threadfence();\n  }\n", src.index(head)))
    src = insert(src, "xs[i] = to_f(x_in[i]);\n  __syncthreads();\n",
                 "  STAMP();\n  BSTAMP(-1);\n")
    end = src.index("\ntemplate <typename CT>\nint launch(")
    end = src.rindex("}\n", 0, end)
    src = src[:end] + "  STAMP();\n" + src[end:]
    first = src.index("\nnamespace {")
    return src[:first] + STAMP_DEFS + src[first:] + STAMP_READERS


def stage_table(stamps, n_layer: int):
    """Per stage, summed over the layers: (work, wait) from ``stamps``
    (start, then entry and exit of each of the 8 barriers of every layer,
    then end), in the stamps' unit; and (total, tail after the last
    barrier)."""
    want = 2 + 2 * len(STAGES) * n_layer
    if len(stamps) != want:
        raise ValueError(f"{len(stamps)} stamps, expected {want}")
    work = [0] * len(STAGES)
    wait = [0] * len(STAGES)
    prev = stamps[0]
    for i in range(len(STAGES) * n_layer):
        entry, leave = stamps[1 + 2 * i], stamps[2 + 2 * i]
        work[i % len(STAGES)] += entry - prev
        wait[i % len(STAGES)] += leave - entry
        prev = leave
    return work, wait, stamps[-1] - stamps[0], stamps[-1] - prev


def barrier_table(starts, entries, exits, n_layer: int):
    """Per stage, summed over the layers, from every block's stamps
    (``starts[b]``; ``entries[b][i]`` and ``exits[b][i]`` of barrier ``i``;
    block 0 first): ``behind``, the last block's entry less block 0's (what
    block 0 waits for the slowest block); ``latency``, block 0's exit less
    the last entry (the barrier itself); ``spread``, the last entry less the
    first; ``span``, the last entry less the first exit from the previous
    barrier (the first start, for the first).  Block 0's wait is ``behind``
    + ``latency``."""
    n = len(STAGES) * n_layer
    if not starts or any(len(e) != n or len(x) != n
                         for e, x in zip(entries, exits)) \
            or len(entries) != len(starts) or len(exits) != len(starts):
        raise ValueError(f"every block needs {n} barrier entries and exits")
    out = {k: [0] * len(STAGES) for k in ("behind", "latency", "spread",
                                          "span")}
    first_out = min(starts)
    for i in range(n):
        s = i % len(STAGES)
        last_in = max(e[i] for e in entries)
        out["behind"][s] += last_in - entries[0][i]
        out["latency"][s] += exits[0][i] - last_in
        out["spread"][s] += last_in - min(e[i] for e in entries)
        out["span"][s] += last_in - first_out
        first_out = min(x[i] for x in exits)
    return out


def stamped_library():
    """The stamped copy of the megakernel, built into build/probe/."""
    src = open(os.path.join(HERE, "eddie_wang_hackathon2023_tpu_torch",
                            "csrc", "decoder_layer.cu")).read()
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "decoder_layer_stamps.cu")
    with open(path, "w") as f:
        f.write(stamped_source(src))
    lib_path = os.path.join(out, "libdecoder_layer_stamps.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, path],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    for fn, argtypes in _build.SIGNATURES["decoder_layer"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.reset_stamps.restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.read_stamps.restype = ctypes.c_int
    lib.read_block_stamps.argtypes = [ctypes.c_void_p] * 3
    lib.read_block_stamps.restype = ctypes.c_int
    return lib


def read_block_stamps(lib, n_barriers: int):
    """(starts, entries, exits) of every block that stamped all
    ``n_barriers`` barriers, block 0 first."""
    bt = (ctypes.c_ulonglong * (2 * MAX_BARRIERS * MAX_BLOCKS))()
    b0 = (ctypes.c_ulonglong * MAX_BLOCKS)()
    bn = (ctypes.c_int * MAX_BLOCKS)()
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    _build.check(lib.read_block_stamps(bt, b0, bn), "read_block_stamps")
    blocks = [b for b in range(MAX_BLOCKS) if bn[b]]
    if blocks != list(range(len(blocks))) or any(
            bn[b] != n_barriers for b in blocks):
        seen = sorted(set(bn[b] for b in blocks))
        raise RuntimeError(f"blocks stamped {seen} barriers, expected "
                           f"{n_barriers} each")

    def at(i, side, b):
        return bt[(2 * i + side) * MAX_BLOCKS + b]
    return ([b0[b] for b in blocks],
            [[at(i, 0, b) for i in range(n_barriers)] for b in blocks],
            [[at(i, 1, b) for i in range(n_barriers)] for b in blocks])


def main():
    import torch
    if not torch.cuda.is_available():
        print("megakernel_stage_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    L, H, D, d, S, Sc, n = 32, 20, 64, 1280, 448, 1500, 44
    blobs = smoke.random_blobs(torch, dev, gen, L, d)
    nf = (blobs.wblob.shape[1] - 6) // 2
    x = torch.randn((1, d), generator=gen, device=dev).bfloat16()
    self_c = torch.randn((L, 1, 2, H, D, S), generator=gen,
                         device=dev).bfloat16()
    cross = torch.randint(-127, 128, (L, 1, 2, H, D, Sc), generator=gen,
                          device=dev, dtype=torch.int8)
    cscale = torch.full((L,), 1 / 40.0, device=dev)
    seq = torch.tensor([n], dtype=torch.int32, device=dev)

    def step(i=0):
        return mk.fused_decoder_stack(x, blobs, self_c, seq, D ** -0.5,
                                      cross_cache=cross, cross_scale=cscale)

    hid, fresh = step()
    kernel_ms, _ = smoke.time_ms(torch, step, iters=20)
    lib = stamped_library()
    _build._LIBS["decoder_layer"] = lib          # the wrapper launches it
    hid_s, fresh_s = step()
    torch.cuda.synchronize()
    print("the stamped megakernel's step is "
          + ("bit-equal to" if torch.equal(hid, hid_s)
             and torch.equal(fresh, fresh_s) else "not bit-equal to")
          + " the kernel's")
    smoke.check(max(smoke.rel_err(hid_s, hid), smoke.rel_err(fresh_s, fresh))
                < 1e-3, "the stamped megakernel computes the step (rel 1e-3)")
    ms, _ = smoke.time_ms(torch, step, iters=20)
    _build.check(lib.reset_stamps(), "reset_stamps")
    step()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * MAX_STAMPS))()
    cnt = ctypes.c_int()
    _build.check(lib.read_stamps(buf, ctypes.byref(cnt)), "read_stamps")
    ns = [buf[2 * i] for i in range(cnt.value)]
    cyc = [buf[2 * i + 1] for i in range(cnt.value)]
    work, wait, total, tail = stage_table(ns, L)
    cwork, cwait, ctotal, ctail = stage_table(cyc, L)
    ghz = ctotal / total
    print(f"step: {ms * 1e3:.1f} us by CUDA events (the stamped kernel; "
          f"{kernel_ms * 1e3:.1f} us the kernel as built); stamps' total "
          f"{total / 1e3:.1f} us, block 0 at {ghz:.3f} GHz by clock64")
    panel_mb = d * d / 1e6
    self_mb = 2 * H * D * (n - 1) * 2 / 1e6
    cross_mb = 2 * H * D * Sc / 1e6
    print(f"per stage, summed over {L} layers (block 0; %globaltimer, and "
          "clock64 at its mean rate):")
    print(f"  {'stage':22s} {'work us':>9s} {'wait us':>9s} "
          f"{'work us':>9s} {'wait us':>9s} {'GEMV MB':>8s} {'GB/s':>7s}")
    for i, name in enumerate(STAGES):
        mb = stage_panels(nf)[i] * panel_mb * L
        other = {1: self_mb, 4: cross_mb}.get(i, 0.0) * L
        # MB over ms of work: GB/s
        rate = (mb or other) / (work[i] / 1e6) if work[i] else float("nan")
        print(f"  {name:22s} {work[i] / 1e3:9.1f} {wait[i] / 1e3:9.1f} "
              f"{cwork[i] / ghz / 1e3:9.1f} {cwait[i] / ghz / 1e3:9.1f} "
              f"{mb:8.1f} {rate:7.1f}" + ("" if mb else
                                         f"  (cache {other:.1f} MB)"))
    gemv = [i for i in range(len(STAGES)) if stage_panels(nf)[i]]
    print(f"  all: work {sum(work) / 1e3:.1f} us (GEMV stages "
          f"{sum(work[i] for i in gemv) / 1e3:.1f}), wait "
          f"{sum(wait) / 1e3:.1f} us, tail {tail / 1e3:.1f} us; GEMV bytes "
          f"{sum(stage_panels(nf)) * panel_mb * L:.1f} MB")
    starts, entries, exits = read_block_stamps(lib, len(STAGES) * L)
    bar = barrier_table(starts, entries, exits, L)
    stamps = sorted(set(starts).union(*entries, *exits))
    tick = min(b - a for a, b in zip(stamps, stamps[1:]))
    print(f"per stage, summed over {L} layers, from all {len(starts)} "
          f"blocks' stamps (%globaltimer, smallest step seen {tick} ns): "
          "block 0's wait = behind (the last block's entry less block 0's) "
          "+ latency (block 0's release less the last entry); spread: the "
          "last entry less the first; span: the first exit from the "
          "previous barrier to the last entry")
    print(f"  {'stage':22s} {'behind us':>9s} {'latency':>9s} "
          f"{'spread us':>9s} {'span us':>9s} {'GB/s':>7s}")
    for i, name in enumerate(STAGES):
        mb = (stage_panels(nf)[i] * panel_mb
              or {1: self_mb, 4: cross_mb}.get(i, 0.0)) * L
        span = bar["span"][i]
        print(f"  {name:22s} {bar['behind'][i] / 1e3:9.1f} "
              f"{bar['latency'][i] / 1e3:9.1f} {bar['spread'][i] / 1e3:9.1f} "
              f"{span / 1e3:9.1f} {mb / (span / 1e6) if span else 0:7.1f}")
    print(f"  all: behind {sum(bar['behind']) / 1e3:.1f} us, latency "
          f"{sum(bar['latency']) / 1e3:.1f} us, spread "
          f"{sum(bar['spread']) / 1e3:.1f} us, span "
          f"{sum(bar['span']) / 1e3:.1f} us")
    smoke.check(abs(total / 1e6 - ms) <= 0.1 * ms,
                f"the stamps' total ({total / 1e3:.1f} us) is within 10% of "
                f"the event-timed step ({ms * 1e3:.1f} us)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
