#!/usr/bin/env python3
"""Where the bf16 ``flash_attention`` kernel's time goes, on one NVIDIA GPU.

    python3 flash_study.py

It builds the port's kernel source (``nnstreamer_tpu_torch/ops/csrc/
flash_attention.cu``) and copies of it, each changed in one place, and
times each at the ViT path's shape — q, k, v the head-split views of one
(64, 256, 1536) bf16 qkv projection — beside
``scaled_dot_product_attention``, one process per copy:

- ``shipped``: the source as it is;
- ``divide``: the epilogue divides each element by l instead of
  multiplying by 1/l;
- ``loads_only``: the consumers wait for each tile and release it at once,
  no math: the floor the load pipeline sets (its output is meaningless
  and not checked);
- ``clocks``: the source with ``clock64()`` sums per phase, printed in µs
  per CTA per call — consumers: waits for Q, K and V, Q·Kᵀ, softmax, P·V,
  epilogue, their whole life; producer: waits for free slots.

Copies and libraries go to ``build/flash_study/``.  Each time is the
median of 7 groups of 30 calls queued behind a spin kernel between two
CUDA events, as ``chip_smoke.py`` times kernels.  Without a card it exits
non-zero.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SRC = os.path.join(HERE, "nnstreamer_tpu_torch", "ops", "csrc",
                   "flash_attention.cu")
OUT = os.path.join(HERE, "build", "flash_study")
B, S, DIM, HEADS = 64, 256, 512, 4
PHASES = ["c_wait_q", "c_wait_k", "c_qk", "c_softmax", "c_wait_v", "c_pv",
          "c_epilogue", "c_total", "p_wait_q", "p_wait_k", "p_wait_v",
          "p_life_qk", "p_life_v"]


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"{src.count(old)} matches for {old!r}")
    return src.replace(old, new)


def _loads_only(src: str) -> str:
    i0 = src.index("        // S = Q·Kᵀ")
    end = "        mbar_arrive(empty_v(vs));\n      }\n"
    i1 = src.index(end) + len(end)
    return src[:i0] + (
        "        mbar_wait(full_k(ks), (it / kKStages) & 1);\n"
        "        mbar_arrive(empty_k(ks));\n"
        "        if (t == n_tiles - 1) mbar_arrive(empty_q(qs));\n"
        "        mbar_wait(full_v(vs), (it / kVStages) & 1);\n"
        "        mbar_arrive(empty_v(vs));\n      }\n") + src[i1:]


def _clocks(src: str) -> str:
    """Phase sums in a __device__ array, read back by nns_fa_clocks."""
    def p(name):
        return f"P[{PHASES.index(name)}]"

    def timed(anchor, name, after=""):
        return (f"tt = clock64(); {anchor} {p(name)} += clock64() - tt;"
                f"{after}")

    src = _sub(src, "namespace {\n\nusing bf16",
               "__device__ unsigned long long g_clocks[16];\n\n"
               "namespace {\n\nusing bf16")
    # consumers
    src = _sub(src, "    int it = 0, n = 0;\n    for (int item = blockIdx.x; "
               "item < n_items; item += gridDim.x, ++n) {\n      const int "
               "bh = item / n_qtiles, q0 = (item - bh * n_qtiles) * kBM;\n      "
               "const int b = bh / H, h = bh - b * H;\n      const int qs = "
               "n % kQStages;\n      const uint32_t sq",
               "    long long P[16] = {0}, T0 = clock64(), tt;\n"
               "    int it = 0, n = 0;\n    for (int item = blockIdx.x; item "
               "< n_items; item += gridDim.x, ++n) {\n      const int bh = "
               "item / n_qtiles, q0 = (item - bh * n_qtiles) * kBM;\n      "
               "const int b = bh / H, h = bh - b * H;\n      const int qs = "
               "n % kQStages;\n      const uint32_t sq")
    w = "mbar_wait(full_q(qs), (n / kQStages) & 1);"
    src = _sub(src, f"      {w}", "      " + timed(w, "c_wait_q"))
    w = "mbar_wait(full_k(ks), (it / kKStages) & 1);"
    src = _sub(src, f"        {w}",
               "        " + timed(w, "c_wait_k", " tt = clock64();"))
    src = _sub(src, "        fence_regs(sc);\n",
               f"        fence_regs(sc);\n        {p('c_qk')} += clock64() - "
               "tt; tt = clock64();\n")
    w = "mbar_wait(full_v(vs), (it / kVStages) & 1);"
    src = _sub(src, f"        {w}",
               f"        {p('c_softmax')} += clock64() - tt;\n        "
               + timed(w, "c_wait_v", " tt = clock64();"))
    src = _sub(src, "        fence_regs(pa);\n        mbar_arrive(empty_v(vs));",
               f"        fence_regs(pa);\n        {p('c_pv')} += clock64() - "
               "tt;\n        mbar_arrive(empty_v(vs));")
    src = _sub(src, "      float inv[2];\n", "      tt = clock64();\n"
               "      float inv[2];\n")
    src = _sub(src, "        asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: "
               "\"memory\");\n      }\n    }\n",
               "        asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: "
               f"\"memory\");\n      }}\n      {p('c_epilogue')} += clock64() "
               "- tt;\n    }\n")
    src = _sub(src, "    if (tid == 0) asm volatile(\"cp.async.bulk.wait_group "
               "0;\\n\" ::: \"memory\");",
               "    if (tid == 0) asm volatile(\"cp.async.bulk.wait_group "
               "0;\\n\" ::: \"memory\");\n"
               f"    {p('c_total')} = clock64() - T0;\n"
               "    if (tid == 0)\n      for (int i = 0; i < 8; ++i) "
               "atomicAdd(&g_clocks[i], (unsigned long long)P[i]);")
    # producer
    src = _sub(src, "    if (ptid == 0) {\n      int it = 0, n = 0;",
               "    long long P[16] = {0}, T0 = clock64(), tt;\n"
               "    if (ptid == 0) {\n      int it = 0, n = 0;")
    for name, w in (("p_wait_q", "mbar_wait(empty_q(qs), ((n / kQStages) & 1)"
                     " ^ 1);"),
                    ("p_wait_k", "mbar_wait(empty_k(s), ((it / kKStages) & 1)"
                     " ^ 1);"),
                    ("p_wait_v", "mbar_wait(empty_v(s), ((it / kVStages) & 1)"
                     " ^ 1);")):
        src = _sub(src, w, timed(w, name))
    flush = ("      for (int i = 8; i < 13; ++i) atomicAdd(&g_clocks[i], "
             "(unsigned long long)P[i]);\n")
    src = _sub(src, "    } else if (ptid == 32) {",
               f"      {p('p_life_qk')} = clock64() - T0;\n{flush}"
               "    } else if (ptid == 32) {")
    src = _sub(src, "                     a * kAtomCols, kt, h, b);\n        }\n"
               "      }\n    }\n  } else {",
               "                     a * kAtomCols, kt, h, b);\n        }\n"
               f"      }}\n      {p('p_life_v')} = clock64() - T0;\n{flush}"
               "    }\n  } else {")
    return src + '''
extern "C" int nns_fa_clocks(unsigned long long* out, int reset) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  if (rc == cudaSuccess && reset) {
    const unsigned long long zero[16] = {0};
    rc = cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  }
  return rc;
}
'''


def variants() -> dict:
    src = open(SRC).read()
    return {
        "shipped": src,
        "divide": _sub(src, "__floats2bfloat162_rn(acc[i] * inv[r], acc[i + 1]"
                       " * inv[r]);", "__floats2bfloat162_rn(acc[i] / l[r], "
                       "acc[i + 1] / l[r]);"),
        "loads_only": _loads_only(src),
        "clocks": _clocks(src),
    }


def build(name: str, src: str):
    """Starts nvcc on one copy; returns (process, library path)."""
    from nnstreamer_tpu_torch.ops import build as b

    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"{name}.cu")
    lib = os.path.join(OUT, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    return subprocess.Popen([b.find_nvcc(), *b.NVCC_FLAGS, "-o", lib, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def time_ms(fn, reps: int = 30, groups: int = 7) -> float:
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(groups):
        e0, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(20_000_000)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def run(name: str, lib_path: str) -> None:
    """One copy, in its own process: check it (but loads_only), time it,
    and for ``clocks`` print the phase sums."""
    import torch

    from nnstreamer_tpu_torch.ops import build as b
    from nnstreamer_tpu_torch.ops import kernels

    lib = ctypes.CDLL(lib_path)
    b._loaded["flash_attention"] = lib   # the wrapper launches this copy
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((B, S, 3 * DIM), generator=g).bfloat16().cuda()
    q, k, v = (t.reshape(B, S, HEADS, DIM // HEADS).transpose(1, 2)
               for t in qkv.split(DIM, dim=-1))
    o = kernels.flash_attention(q, k, v)
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    while not ev.query():
        if time.perf_counter() - t0 > 20:
            print(f"{name}: no completion within 20 s", flush=True)
            os._exit(3)
        time.sleep(0.001)
    err = float((o.float() - kernels.flash_attention_reference(q, k, v)
                 .float()).abs().max())
    if name != "loads_only" and err > 1e-2:
        raise RuntimeError(f"{name}: {err} off the plain version")
    ms = time_ms(lambda: kernels.flash_attention(q, k, v))
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v))
    print(f"flash_study {name}: {ms:.6f} ms, sdpa {sdpa:.6f} ms, "
          f"max_abs_diff {err:.6g}", flush=True)
    if name != "clocks":
        return
    buf = (ctypes.c_ulonglong * 16)()
    lib.nns_fa_clocks(buf, 1)
    reps = 30
    for _ in range(reps):
        kernels.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if lib.nns_fa_clocks(buf, 0) != 0:
        raise RuntimeError("clocks: reading the sums failed")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True).stdout.split()[0])
    ctas = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"flash_study clocks: µs per CTA per call at {mhz:.0f} MHz "
          "(consumer phases: mean of the two warpgroups)", flush=True)
    for i, phase in enumerate(PHASES):
        per = (2 if phase.startswith("c_") else 1) * ctas * reps
        print(f"flash_study clocks {phase:11s} {buf[i] / per / mhz:8.3f}",
              flush=True)


def main() -> int:
    if len(sys.argv) == 3:
        run(sys.argv[1], sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_study: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    started = {n: build(n, src) for n, src in variants().items()}
    for name, (proc, lib) in started.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    for name, (_, lib) in started.items():
        r = subprocess.run([sys.executable, os.path.abspath(__file__), name,
                            lib], capture_output=True, text=True, timeout=300)
        print(r.stdout, end="", flush=True)
        if r.returncode:
            raise RuntimeError(f"{name} failed:\n{r.stderr[-3000:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
