#!/usr/bin/env python3
"""Where kernel 2's causal call spends its time, on one NVIDIA GPU.

    python3 tools/flash_causal_probe.py

At the custom path's shape, [1,20,227,64] bf16 with the wrapper's plan,
builds copies of ``csrc/flash_attention.cu`` into ``build/probe/``, each
changed by a text edit, and times them with CUDA events behind a spin as
``chip_smoke.py`` does:
  * ``kernel``: the source as it is;
  * ``empty``: every block returns at once (the launch with nothing to do);
  * ``no loads``: no K or V is copied (Q is);
  * ``no tiles``: no warp computes its tile (the loads and the combine).
Then a copy stamped by ``%globaltimer`` prints, for the block of the last
rows (the most keys) averaged over the heads, its phases as thread 0 sees
them: issuing the copies, waiting for K, the scores and softmax, waiting
for V, P V, and the combine's first barrier.
"""
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
SOURCE = os.path.join(HERE, "eddie_wang_hackathon2023_tpu_torch", "csrc",
                      "flash_attention.cu")
B, H, L = 1, 20, 227

VARIANTS = {
    "kernel": [],
    "empty": [("  const int off = Lk - Lq;\n  const __nv_bfloat16* qb",
               "  const int off = Lk - Lq;\n  if (valid > 0) return;\n"
               "  const __nv_bfloat16* qb")],
    "no loads": [("    for (int r = tid >> 3; r < rows; r += step, p += "
                  "step * ld)",
                  "    for (int r = tid >> 3; r < (dst == qs ? rows : 0); "
                  "r += step, p += step * ld)")],
    "no tiles": [("const bool live = n0 < warp_lim,",
                  "const bool live = false && n0 < warp_lim,")],
}
STAMPS = '''__device__ unsigned long long g_st[4096][7];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}
extern "C" int read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_st, (size_t)n * 56);
}
'''
STAMPED = [
    ("  const int off = Lk - Lq;\n  const __nv_bfloat16* qb",
     "  const int off = Lk - Lq;\n  unsigned long long ts[7] = {gtime()};\n"
     "  const __nv_bfloat16* qb"),
    ("    stage_v(1, 1);\n  }\n  asm volatile(\"cp.async.commit_group;\\n\" ::);\n",
     "    stage_v(1, 1);\n  }\n  asm volatile(\"cp.async.commit_group;\\n\" ::);\n"
     "  ts[1] = gtime();\n"),
    ("    __syncthreads();                   // landed for all\n",
     "    __syncthreads();                   // landed for all\n"
     "    if (j == 0) ts[2] = gtime();\n"),
    ("    if (j == 0) {                      // round 0's V\n",
     "    if (j == 0) ts[3] = gtime();\n"
     "    if (j == 0) {                      // round 0's V\n"),
    ("    if (live) {\n      if (masked)\n        pv(",
     "    if (j == 0) ts[4] = gtime();\n"
     "    if (live) {\n      if (masked)\n        pv("),
    ("#pragma unroll\n  for (int off_ = 1; off_ < 4; off_ <<= 1) {",
     "  ts[5] = gtime();\n#pragma unroll\n"
     "  for (int off_ = 1; off_ < 4; off_ <<= 1) {"),
    ("  __syncthreads();\n  // each block row: 32 column pairs",
     "  __syncthreads();\n  ts[6] = gtime();\n"
     "  if (tid == 0 && blockIdx.y * gridDim.x + blockIdx.x < 4096)\n"
     "    for (int i = 0; i < 7; ++i)\n"
     "      g_st[blockIdx.y * gridDim.x + blockIdx.x][i] = ts[i];\n"
     "  // each block row: 32 column pairs"),
]
PHASES = ("issue the copies", "K landed", "scores and softmax", "V landed",
          "P V", "to the combine's barrier")


def edited(text, pairs):
    for a, b in pairs:
        if a not in text:
            raise RuntimeError(f"the source has changed: {a[:60]!r}")
        text = text.replace(a, b, 1)
    return text


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_causal_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    text = open(SOURCE).read()
    ns = text.index("namespace {")
    sources = {name: edited(text, pairs) for name, pairs in VARIANTS.items()}
    sources["stamped"] = edited(text[:ns] + STAMPS + text[ns:], STAMPED)
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        path = os.path.join(out, f"flash_causal_{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"flash_causal_{i}.so"))
        lib.flash_attention.argtypes = \
            _build.SIGNATURES["flash_attention"]["flash_attention"]
        libs[name] = lib

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fa.causal_plan(L, L, L, B * H, sms)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, L, 3, H, 64, generator=g, device=dev).bfloat16()
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    o = torch.empty(B, H, L, 64, device=dev, dtype=torch.bfloat16)
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, o) for s in t.stride()[:3]])

    def call(lib):
        return lambda i: lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, L,
            L, 64, L, 1, plan["rows"], plan["splits"],
            ctypes.cast(strides, ctypes.c_void_p), 0.125,
            torch.cuda.current_stream().cuda_stream)

    print(f"[{B},{H},{L},64] bf16 causal, plan {plan}:")
    for name in VARIANTS:
        if call(libs[name])(0) != 0:
            raise RuntimeError(f"{name}: the launch failed")
        ms = smoke.time_ms(torch, call(libs[name]))[0]
        print(f"  {name}: {ms * 1e3:.2f} us a call")
    stamped = libs["stamped"]
    smoke.spin(torch, 1.0)
    call(stamped)(0)
    torch.cuda.synchronize()
    n = plan["row_blocks"] * B * H
    buf = (ctypes.c_ulonglong * (n * 7))()
    if stamped.read_stamps(ctypes.cast(buf, ctypes.c_void_p), n):
        raise RuntimeError("read_stamps failed")
    st = torch.tensor(list(buf), dtype=torch.float64).view(n, 7)
    last = st[torch.arange(B * H) * plan["row_blocks"]]   # blockIdx.x 0
    steps = [(last[:, i + 1] - last[:, i]).mean() for i in range(6)]
    print("  the last rows' block, ns: " + ", ".join(
        f"{p} {float(t):.0f}" for p, t in zip(PHASES, steps)))
    print(f"  span of the grid, first start to last combine: "
          f"{float(st[:, 6].max() - st[:, 0].min()):.0f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
