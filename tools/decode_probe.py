"""Latency probe for the guided-decode kernel's design, on the card (an H100).

    python3 tools/decode_probe.py

Latencies in SM cycles, from CTA 0 of a cooperative grid of 8 and of 128
CTAs (256 threads): one dependent ld.global.cg of a line another CTA wrote,
eight independent ones, a 5-step warp sum, a __syncthreads, an ld.global.nc,
a grid barrier of the decode kernel's kind (an arrival counter,
red.release.gpu and an ld.acquire.gpu poll) after that work; then 200 such
barriers back to back, and 200 of cooperative_groups' grid.sync (the
barrier the kernel does not use), each as cycles a barrier. Built with
nvcc into
build/probe/; every line names the card and its power limit. PERF.md reads
them to say what bounds a phase of the decode.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

LATENCY_CU = r"""
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ void bar(unsigned* b, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(b) : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(b) : "memory");
    } while (v < target);
  }
  __syncthreads();
}
// Waits for v (a real instruction that reads it) before the next clock
// read: volatile asm statements keep their order.
__device__ __forceinline__ float use(float v) {
  float r;
  asm volatile("add.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}
__global__ void k(unsigned* b, float* data, long long* out, int iters) {
  unsigned target = 0;
  long long acc[6] = {0};
  float sink = 0.f;
  for (int it = 0; it < iters; ++it) {
    data[(blockIdx.x * 512 + threadIdx.x) % (1 << 20)] = it + threadIdx.x;
    bar(b, target);
    long long t0 = clock64();
    float v = __ldcg(data + ((blockIdx.x + 1) % gridDim.x) * 512 + threadIdx.x);
    sink += use(v);
    long long t1 = clock64();
    float w[8];
    for (int i = 0; i < 8; ++i)
      w[i] = __ldcg(data + ((blockIdx.x + 2 + i) % gridDim.x) * 512 + threadIdx.x);
    float s2 = 0;
    for (int i = 0; i < 8; ++i) s2 += w[i];
    sink += use(s2);
    long long t2 = clock64();
    float x = sink;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    sink += use(x);
    long long t3 = clock64();
    __syncthreads();
    long long t4 = clock64();
    sink += use(__ldg(data + (1 << 20) + threadIdx.x));
    long long t5 = clock64();
    bar(b, target);
    long long t6 = clock64();
    if (threadIdx.x == 0) {
      acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += t3 - t2;
      acc[3] += t4 - t3; acc[4] += t5 - t4; acc[5] += t6 - t5;
    }
  }
  // Back to back: the decode's barrier, then grid.sync, 200 of each.
  bar(b, target);
  long long t7 = clock64();
  for (int i = 0; i < 200; ++i) bar(b, target);
  long long t8 = clock64();
  for (int i = 0; i < 200; ++i) cooperative_groups::this_grid().sync();
  long long t9 = clock64();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) out[i] = acc[i] / iters;
    out[6] = (t8 - t7) / 200;
    out[7] = (t9 - t8) / 200;
  }
  if (sink == 12345.f) out[8] = 1;
}
int main() {
  unsigned* b; float* d; long long* o;
  cudaMalloc(&b, 4);
  cudaMalloc(&d, (2 << 20) * 4); cudaMemset(d, 0, (2 << 20) * 4);
  cudaMalloc(&o, 72);
  for (int g : {8, 128}) {
    cudaMemset(b, 0, 4); cudaMemset(o, 0, 72);
    int iters = 200;
    void* args[] = {&b, &d, &o, &iters};
    cudaError_t e = cudaLaunchCooperativeKernel((void*)k, dim3(g), dim3(256), args, 0, 0);
    cudaDeviceSynchronize();
    long long h[9];
    cudaMemcpy(h, o, 72, cudaMemcpyDeviceToHost);
    printf("grid %d (cudaError %d), SM cycles: 1 ldcg %lld | 8 ldcg %lld | "
           "warp_sum %lld | syncthreads %lld | ldg %lld | barrier %lld; "
           "back to back: barrier %lld | grid.sync %lld\n",
           g, int(e), h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7]);
  }
}
"""

def latency() -> None:
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "latency.cu").write_text(LATENCY_CU)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-O3", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-o", str(out / "latency"),
                    str(out / "latency.cu")], check=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    for line in subprocess.run([str(out / "latency")], check=True,
                               capture_output=True, text=True,
                               timeout=120).stdout.splitlines():
        print(line, "on", card.strip(), flush=True)


if __name__ == "__main__":
    if sys.argv[1:]:
        raise SystemExit(__doc__)
    latency()
