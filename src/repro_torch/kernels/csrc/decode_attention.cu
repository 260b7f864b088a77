// Decode attention for Hopper: one new token per sequence against a KV cache
// with ragged lengths, online softmax in fp32, optional tanh softcap.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`decode_attention`, body `_decode_kernel`). As there, each KV tile is
// scored against the whole GQA query group, so the cache is read once per
// group and not once per query head. The TPU kernel walks the tiles as a
// sequential grid axis; here the cache is cut into splits of SPLIT keys
// (flash-decoding), each split is one thread block, and a second kernel
// merges the splits' partial results.
//
// Layout: q (B, H, D), k_cache and v_cache (B, S, KVH, D), lengths (B,)
// int32, o (B, H, D), all contiguous and 16-byte aligned. fp32 or bf16 in, the
// same dtype out. The fp32 scratch of the partials, allocated by the caller:
// m and l (B, KVH, n_splits, group), acc (B, KVH, n_splits, group, D), with
// n_splits = ceil(S / SPLIT) taken from the cache length, never from lengths.
//
// What bounds it on the H100: the bytes. Decode reads every valid cached key
// and value once and does four FLOPs per key and query head. The design:
//
// * split kernel, grid (n_splits, KVH x ceil(group / MAXG), B). A split at or
//   past lengths[b] writes an empty partial (m = NEG_INF, l = 0, acc = 0) and
//   returns at once, so only the live splits read the cache: at llama3.2-1b's
//   serving shape about 5 of 16 per (sequence, kv head), some 320 busy blocks
//   on 132 SMs. Each lane loads 16 bytes of a key row at a time (8 bf16 or 4
//   fp32; neighbouring lanes on neighbouring addresses), all of its loads
//   issued before the first is used, with the query group's matching slice in
//   registers. A row wider than a warp's 32 loads (fp32 at D = 256) gives
//   each lane two slices of it, 32 loads apart, and half as many rows in
//   flight. Each lane keeps an online softmax over the keys it sees;
//   the lanes of a warp merge theirs with shuffles, and the four warps merge
//   through shared memory once, at the end. Keys at or past the length are
//   not read: their scores are NEG_INF and their V rows zero.
// * combine kernel, one warp per (sequence, query head): it reads the live
//   splits only (those below ceil(len / SPLIT)), in split order, so the result
//   is deterministic, and writes out = sum_i exp(m_i - M) acc_i / sum_i
//   exp(m_i - M) l_i with M = max_i m_i, or zeros where that sum is 0 (a
//   sequence of length 0), as the reference does.

#include "common.cuh"

namespace {

constexpr int NW = 4;  // warps per block
constexpr int NT = NW * 32;
constexpr int MAXG = 4;  // query heads per block; a larger group takes several blocks
// keys per split: one 64-key tile. 128 measured at par on an H100 at
// llama3.2-1b's serving shape (PERF.md), and 64 parallelises better at small
// batches. The wrapper (decode_attention.py) sizes the scratch with the same
// value.
constexpr int SPLIT = 64;

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int S, int H, int KVH, int n_splits, float sm_scale,
    float softcap) {
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int ROW = D / VEC;              // 16-byte loads per key row
  constexpr int LPR = ROW < 32 ? ROW : 32;  // lanes per key row
  constexpr int LDS = ROW / LPR;            // 16-byte loads per lane and row (2: fp32 D = 256)
  constexpr int E = LDS * VEC;              // elements per lane and row
  constexpr int RPW = 32 / LPR;             // key rows per warp-wide load
  constexpr int KPW = SPLIT / NW;           // keys per warp
  constexpr int NI = KPW / RPW;             // key rows per lane
  constexpr int CH0 = 8 / LDS;              // key rows per lane in flight at once
  constexpr int CH = NI < CH0 ? NI : CH0;
  static_assert(ROW % LPR == 0 && 32 % LPR == 0 && KPW % RPW == 0 && NI % CH == 0,
                "split, head dim and load width do not tile a warp");

  __shared__ float sm_m[NW][MAXG], sm_l[NW][MAXG];
  __shared__ __align__(16) float sm_acc[NW][MAXG][D];

  const int group = H / KVH;
  const int n_gc = (group + MAXG - 1) / MAXG;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_gc;
  const int g0 = (blockIdx.y % n_gc) * MAXG;
  const int ng = min(MAXG, group - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = max(0, min(lengths[b], S));
  const int k0 = split * SPLIT;
  const size_t pbase = ((static_cast<size_t>(b) * KVH + kvh) * n_splits + split) * group + g0;

  if (k0 >= len) {  // empty split: nothing to read
    for (int i = tid; i < ng * D; i += NT) acc_part[pbase * D + i] = 0.f;
    for (int i = tid; i < ng; i += NT) {
      m_part[pbase + i] = kNegInf;
      l_part[pbase + i] = 0.f;
    }
    return;
  }

  // this lane's 16-byte slices of a row: elements (c + LPR * j) * VEC .., j < LDS
  const int c = lane % LPR;
  const int rg = lane / LPR;  // which of the warp's RPW rows this lane loads
  const size_t kv_row = static_cast<size_t>(KVH) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * D + c * VEC;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * D + c * VEC;

  float qr[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int j = 0; j < LDS; ++j) {
      float f[VEC];
      if (g < ng) {
        const size_t off =
            (static_cast<size_t>(b) * H + kvh * group + g0 + g) * D + (c + LPR * j) * VEC;
        unpack(*reinterpret_cast<const uint4*>(q + off), f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][j * VEC + e] = f[e];
    }
  }

  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int i0 = 0; i0 < NI; i0 += CH) {
    uint4 kr[CH][LDS], vr[CH][LDS];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int key = k0 + warp * KPW + (i0 + i) * RPW + rg;
#pragma unroll
      for (int j = 0; j < LDS; ++j) {
        if (key < len) {
          kr[i][j] = __ldg(reinterpret_cast<const uint4*>(kb + key * kv_row + LPR * j * VEC));
          vr[i][j] = __ldg(reinterpret_cast<const uint4*>(vb + key * kv_row + LPR * j * VEC));
        } else {  // past the length: never read; V zero, the score masked below
          kr[i][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[i][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int key = k0 + warp * KPW + (i0 + i) * RPW + rg;
      float kf[E], vf[E];
#pragma unroll
      for (int j = 0; j < LDS; ++j) {
        float kj[VEC], vj[VEC];
        unpack(kr[i][j], kj);
        unpack(vr[i][j], vj);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kf[j * VEC + e] = kj[e];
          vf[j * VEC + e] = vj[e];
        }
      }
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[g][e], kf[e], x);
        s[g] = x;
      }
      // the LPR lanes of a row hold the row's slices: sum them
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < MAXG; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float x = s[g] * sm_scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = key < len ? x : kNegInf;
        const float m_new = fmaxf(m[g], x);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(x - m_new);
        l[g] = alpha * l[g] + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], alpha * acc[g][e]);
        m[g] = m_new;
      }
    }
  }

  // merge the warp's RPW row groups: lanes LPR, 2 LPR, ... apart hold the same slice
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float m_new = fmaxf(m[g], mo);
      const float a = expf(m[g] - m_new), ao = expf(mo - m_new);
      l[g] = a * l[g] + ao * lo;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = a * acc[g][e] + ao * __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      m[g] = m_new;
    }
  }

  // merge the block's warps once, through shared memory
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int j = 0; j < LDS; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][g][(c + LPR * j) * VEC + e] = acc[g][j * VEC + e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += NT) {
    const int g = i / D, d = i % D;
    float mx = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = expf(sm_m[w][g] - mx);
      a = fmaf(wt, sm_acc[w][g][d], a);
      sum = fmaf(wt, sm_l[w][g], sum);
    }
    acc_part[pbase * D + i] = a;
    if (d == 0) {
      m_part[pbase + g] = mx;
      l_part[pbase + g] = sum;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, const int* __restrict__ lengths, T* __restrict__ o,
    int B, int S, int H, int KVH, int n_splits) {
  constexpr int DL = (D + 31) / 32;  // output columns per lane (D = 16: lanes 0-15)
  const int wid = blockIdx.x * NW + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (wid >= B * H) return;
  const int b = wid / H, h = wid % H;
  const int group = H / KVH;
  const int len = max(0, min(lengths[b], S));
  const int live = (len + SPLIT - 1) / SPLIT;
  // partial (b, h / group, i, h % group) of split i
  const size_t base = (static_cast<size_t>(b) * KVH + h / group) * n_splits * group + h % group;

  float mx = kNegInf;
  for (int i = 0; i < live; ++i) mx = fmaxf(mx, m_part[base + static_cast<size_t>(i) * group]);
  float sum = 0.f, a[DL];
#pragma unroll
  for (int j = 0; j < DL; ++j) a[j] = 0.f;
  for (int i = 0; i < live; ++i) {
    const size_t p = base + static_cast<size_t>(i) * group;
    const float wt = expf(m_part[p] - mx);
    sum = fmaf(wt, l_part[p], sum);
#pragma unroll
    for (int j = 0; j < DL; ++j)
      if (D % 32 == 0 || lane + 32 * j < D)
        a[j] = fmaf(wt, acc_part[p * D + lane + 32 * j], a[j]);
  }
  const float inv = 1.f / (sum == 0.f ? 1.f : sum);  // an empty sequence outputs zeros
#pragma unroll
  for (int j = 0; j < DL; ++j)
    if (D % 32 == 0 || lane + 32 * j < D)
      o[static_cast<size_t>(wid) * D + lane + 32 * j] = from_f<T>(a[j] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
                   void* m_part, void* l_part, void* acc_part, int B, int S, int H, int KVH,
                   float sm_scale, float softcap, cudaStream_t stream) {
  const int n_splits = (S + SPLIT - 1) / SPLIT;
  const int n_gc = (H / KVH + MAXG - 1) / MAXG;
  if (static_cast<long long>(KVH) * n_gc > 65535 || B > 65535) return cudaErrorInvalidValue;
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  float* acc = static_cast<float*>(acc_part);
  const int* lens = static_cast<const int*>(lengths);
  if (n_splits > 0) {
    decode_split_kernel<T, D><<<dim3(n_splits, KVH * n_gc, B), NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens, m,
        l, acc, S, H, KVH, n_splits, sm_scale, softcap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  decode_combine_kernel<T, D><<<(B * H + NW - 1) / NW, NT, 0, stream>>>(
      m, l, acc, lens, static_cast<T*>(o), B, S, H, KVH, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* lengths,
                       void* o, void* m_part, void* l_part, void* acc_part, int B, int S, int H,
                       int KVH, float sm_scale, float softcap, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, m_part, l_part, acc_part, B, S, H, KVH,
                           sm_scale, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, m_part, l_part, acc_part, B, S, H, KVH,
                           sm_scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, m_part, l_part, acc_part, B, S, H, KVH,
                            sm_scale, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, o, m_part, l_part, acc_part, B, S, H, KVH,
                            sm_scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the split kernel and then the combine kernel on `stream`, and
// returns the first CUDA error of the two launches (0 on success); the wrapper
// raises on anything else. The caller sizes the scratch for ceil(S / SPLIT)
// splits and checks shapes, dtypes, devices, alignment and contiguity.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, void* m_part, void* l_part,
                                    void* acc_part, int dtype, int B, int S, int H, int KVH,
                                    int D, float sm_scale, float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 16)  // the smoke configs' head dim, fp32 only
    return launch<float, 16>(q, k, v, lengths, o, m_part, l_part, acc_part, B, S, H, KVH,
                             sm_scale, softcap, st);
  if (dtype == kFloat32)
    return dispatch_d<float>(D, q, k, v, lengths, o, m_part, l_part, acc_part, B, S, H, KVH,
                             sm_scale, softcap, st);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, o, m_part, l_part, acc_part, B, S,
                                     H, KVH, sm_scale, softcap, st);
  return cudaErrorInvalidValue;
}
