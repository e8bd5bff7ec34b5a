// Smith-Waterman candidate scoring for Hopper, called through jax.ffi.
//
// One thread scores one (query, target) pair. The query side is short
// (spacer ORFs, at most 32 residues), so the whole DP column -- H and E
// for every query row -- lives in registers, and the target is walked
// column by column. Each warp serves the candidates of ONE query; its
// profile (21 letters x LQ int8 scores, composition bias folded in)
// sits in shared memory, and the per-column substitution scores are a
// shared-memory row read indexed by the target letter.
//
// The DP is a chain of int32 max/add steps, which Hopper runs through
// its DPX instructions (__viaddmax_s32 and friends). Semantics are
// those of ops.align._forward_pass (Farrar's sw_sse2 update: E reads H
// before the lazy-F correction, every value floors at 0), written as
// the per-row recurrence F[j+1] = max(F[j] - gapE, h_pre[j] - gapO).
// ops/sw_cuda.py holds a NumPy model of exactly this loop.
//
// Query rows past the query's length carry the profile value -128: a
// value derived there never exceeds one already counted in `best`, so
// padding to the template length LQ leaves every score unchanged.
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLetters = 21;
constexpr int kWarpsPerBlock = 4;

// Shared-memory row stride in bytes: consecutive letters start in
// different 16-byte bank groups, so lanes reading different letters
// conflict less.
template <int LQ>
struct RowStride {
  static constexpr int value = LQ == 32 ? 48 : 16;
};

__device__ __forceinline__ int SByte(uint32_t word, int k) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * k)) & 0xff));
}

template <int LQ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
SwPairsKernel(const int8_t* __restrict__ prof,      // [n_queries, 21, LQ]
              const uint8_t* __restrict__ tseq,     // 16-byte aligned starts
              const int32_t* __restrict__ warp_q,   // [n_warps]
              const int32_t* __restrict__ slot_toff,  // [n_warps * 32]
              const int32_t* __restrict__ slot_tlen,  // [n_warps * 32]
              int32_t* __restrict__ out,              // [n_warps * 32]
              int n_warps, int gap_open, int gap_extend) {
  constexpr int kStride = RowStride<LQ>::value;
  constexpr int kChunks = LQ / 16;
  __shared__ __align__(16) int8_t sprof[kWarpsPerBlock][kLetters * kStride];

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarpsPerBlock + wib;
  if (w >= n_warps) return;

  const uint4* src = reinterpret_cast<const uint4*>(
      prof + static_cast<size_t>(warp_q[w]) * kLetters * LQ);
  for (int i = lane; i < kLetters * kChunks; i += 32) {
    const int row = i / kChunks;
    const int part = i % kChunks;
    *reinterpret_cast<uint4*>(&sprof[wib][row * kStride + part * 16]) =
        __ldg(src + i);
  }
  __syncwarp();

  const int slot = w * 32 + lane;
  const int tlen = slot_tlen[slot];
  const uint4* t4 = reinterpret_cast<const uint4*>(tseq + slot_toff[slot]);
  const int8_t* qprof = sprof[wib];

  int H[LQ];
  int E[LQ];
#pragma unroll
  for (int j = 0; j < LQ; ++j) {
    H[j] = 0;
    E[j] = 0;
  }
  int best = 0;
  const int go = gap_open;
  const int ge = gap_extend;

  for (int c0 = 0; c0 < tlen; c0 += 16) {
    const uint4 chunk = __ldg(t4 + (c0 >> 4));
    const uint32_t letters[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
    const int n = min(16, tlen - c0);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < n) {
        const int letter = (letters[k >> 2] >> (8 * (k & 3))) & 0xff;
        const int8_t* row = qprof + letter * kStride;
        uint32_t words[LQ / 4];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * c);
          words[4 * c + 0] = v.x;
          words[4 * c + 1] = v.y;
          words[4 * c + 2] = v.z;
          words[4 * c + 3] = v.w;
        }
        int diag = 0;          // H of row j-1 in the previous column
        int F = -(1 << 28);    // query-gap state entering row j
#pragma unroll
        for (int j = 0; j < LQ; ++j) {
          const int s = SByte(words[j >> 2], j & 3);
          const int hp = __viaddmax_s32_relu(diag, s, E[j]);  // max(d+s,E,0)
          diag = H[j];
          const int hpo = hp - go;
          E[j] = __vimax_s32_relu(hpo, E[j] - ge);   // max(hp-go, E-ge, 0)
          const int h = max(hp, F);
          F = __viaddmax_s32(F, -ge, hpo);          // max(F-ge, hp-go)
          H[j] = h;
          best = max(best, h);
        }
      }
    }
  }
  out[slot] = best;
}

template <int LQ>
void Launch(cudaStream_t stream, const int8_t* prof, const uint8_t* tseq,
            const int32_t* warp_q, const int32_t* toff, const int32_t* tlen,
            int32_t* out, int n_warps, int go, int ge) {
  const int blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  SwPairsKernel<LQ><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      prof, tseq, warp_q, toff, tlen, out, n_warps, go, ge);
}

ffi::Error SwPairsImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> prof,
                       ffi::Buffer<ffi::U8> tseq,
                       ffi::Buffer<ffi::S32> warp_q,
                       ffi::Buffer<ffi::S32> slot_toff,
                       ffi::Buffer<ffi::S32> slot_tlen,
                       ffi::ResultBuffer<ffi::S32> out, int32_t lq,
                       int32_t gap_open, int32_t gap_extend) {
  const int n_warps = static_cast<int>(warp_q.element_count());
  if (slot_toff.element_count() != static_cast<size_t>(n_warps) * 32 ||
      slot_tlen.element_count() != static_cast<size_t>(n_warps) * 32 ||
      out->element_count() != static_cast<size_t>(n_warps) * 32) {
    return ffi::Error::InvalidArgument("sw_pairs: slot arrays must hold 32 "
                                       "entries per warp");
  }
  if (n_warps == 0) return ffi::Error::Success();
  const int8_t* p = prof.typed_data();
  const uint8_t* t = tseq.typed_data();
  const int32_t* wq = warp_q.typed_data();
  const int32_t* to = slot_toff.typed_data();
  const int32_t* tl = slot_tlen.typed_data();
  int32_t* o = out->typed_data();
  switch (lq) {
    case 16:
      Launch<16>(stream, p, t, wq, to, tl, o, n_warps, gap_open, gap_extend);
      break;
    case 32:
      Launch<32>(stream, p, t, wq, to, tl, o, n_warps, gap_open, gap_extend);
      break;
    default:
      return ffi::Error::InvalidArgument("sw_pairs: lq must be 16 or 32");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SwPairs, SwPairsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("lq")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));
