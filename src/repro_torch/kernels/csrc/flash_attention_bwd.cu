// Flash-attention backward for Hopper: dq, dk, dv of causal / sliding-window /
// tanh-softcapped GQA attention with a q_offset, from the forward's output and
// its per-row log-sum-exp.
//
// Replaces the backward of the reference's differentiable attention,
// src/repro/kernels/flash_vjp.py (`_make`, `bwd`, lines 101-142), which in its
// own docstring stands in for the TPU's Pallas kernel pair: save only
// (out, lse), stream the KV chunks again, rebuild p = exp(s - lse), take
// delta = rowsum(dout * out), ds = p (dp - delta) (times 1 - t^2 under a
// softcap, t the tanh of the capped score), and fold the GQA groups back onto
// the kv heads. Its plain PyTorch version is kernels/flash_vjp.py (`flash_bwd`).
//
// Layout: q, out, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, KVH, D); lse
// and delta (B, H, Sq) fp32. fp32 or bf16 in (all the same), gradients in that
// dtype; every product, p, ds and every sum are fp32.
//
// Three kernels on the caller's stream, none with an atomic, so the result is
// the same bit for bit from run to run (the trainer's crash-and-resume check
// relies on it):
//   1. delta: one warp per query row, delta = sum_d dout * out.
//   2. dk, dv: one block per (64-key tile, batch x kv head). It keeps its K and
//      V tiles in shared memory and its dk, dv tiles in registers, and loops
//      over the query heads of its GQA group and, for each, over the query
//      tiles its mask can reach (all of them without a mask; under causal and
//      window only those rows that see a key of the tile), recomputing
//      S = Q K^T and dP = dO V^T a tile at a time: dv += P^T dO, dk += dS^T Q.
//      The group's sum happens in registers, so no block writes another's rows.
//   3. dq: one block per (64-row query tile, batch x head), looping over the
//      KV tiles its mask reaches, recomputing S and dP: dq += dS K.
// Rows and keys past Sq and Skv are zero-filled in shared memory and masked.
// A query row that no key is visible to gets p = 0 everywhere, so it adds
// nothing (its forward row is zeros; csrc/flash_attention.cu).
//
// What bounds it on the H100: at llama3.2-1b's training shape (q (8,256,32,64),
// k/v (8,256,8,64), causal, bf16) the five products over the 8.4 M kept
// (query, key) pairs are 5.4 GFLOP, 5.5 us at 989 TFLOP/s bf16, against
// 42 MB of q, k, v, out, dout, lse, dq, dk, dv, 12.6 us at 3.35 TB/s: the
// bytes bound it, and both are small. This first version is the simple,
// right one: CUDA-core FMAs in fp32 from shared-memory tiles (each thread a
// 4x4 block of a 64x64 product, or of the 64 x D gradient tile in columns 16
// apart, so that rows padded by one float keep the lanes on distinct banks),
// and it recomputes S and dP in both the dk/dv and the dq kernel (seven
// products where five would do) to avoid atomics. It stays far from the tensor-core bound; the mma / wgmma
// form of the forward kernel is the later redesign (ROADMAP B.1).
//
// Tiles: 64 rows at head dims 16-128; 32 at D = 256, where four 64-row fp32
// tiles of 257 floats would not fit the 227 KB a block may have. Shared
// memory is dynamic and opted in above 48 KB (165,888 bytes at D = 128).

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block: a 16 x 16 grid

template <int D>
struct Tile {
  static constexpr int B = D <= 128 ? 64 : 32;  // query rows and keys per tile
};

template <int D>
constexpr size_t smem_bytes(int score_tiles) {
  constexpr int B = Tile<D>::B;
  // four B x (D + 1) tiles (K, V, Q, dO), `score_tiles` B x (B + 1) tiles
  // (P and dS, or dS), and the rows' lse and delta
  return sizeof(float) *
         (4 * B * (D + 1) + static_cast<size_t>(score_tiles) * B * (B + 1) + 2 * B);
}

// delta[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d]; one warp a row
template <typename T>
__global__ void __launch_bounds__(NT) bwd_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
    int Sq, int H, int D, size_t rows) {
  const size_t row = static_cast<size_t>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const T* o_row = out + row * D;
  const T* g_row = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(g_row[d]), to_f(o_row[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const size_t bi = row / H;  // b * Sq + i
    const size_t b = bi / Sq;
    delta[(b * H + h) * Sq + bi % Sq] = s;
  }
}

// a B x D tile of a (rows, heads, D) tensor into shared memory as fp32, rows
// padded to D + 1; rows at or past `n` are zero
template <typename T, int D, int B>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t row_stride, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < B * D; i += NT) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < n ? to_f(src[static_cast<size_t>(r0 + r) * row_stride + d])
                                      : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for this thread's rows ty * TM + r and keys
// tx + 16 c of the B x B tile
template <int D, int B>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* Os, const float* Ks,
                                            const float* Vs, int ty, int tx,
                                            float (&s)[B / 16][B / 16],
                                            float (&dp)[B / 16][B / 16]) {
  constexpr int TM = B / 16, DP = D + 1;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[TM], ov[TM], kv[TM], vv[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      qv[r] = Qs[(ty * TM + r) * DP + d];
      ov[r] = Os[(ty * TM + r) * DP + d];
    }
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      kv[c] = Ks[(tx + 16 * c) * DP + d];
      vv[c] = Vs[(tx + 16 * c) * DP + d];
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TM; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
}

struct Mask {
  int Sq, Skv, causal, window, q_offset;
  float sm_scale, softcap;

  // p and ds of one (query row qi, key kp) pair from its raw score and dP
  __device__ __forceinline__ void grads(float raw, float dpv, float lse, float delta, int qi,
                                        int kp, float& p, float& ds) const {
    float x = raw * sm_scale, t = 0.f;
    if (softcap > 0.f) {
      t = tanhf(x / softcap);
      x = t * softcap;
    }
    const int qp = q_offset + qi;
    bool ok = kp < Skv && qi < Sq;
    if (causal) ok = ok && kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
    p = ok ? expf(x - lse) : 0.f;
    ds = p * (dpv - delta);
    if (softcap > 0.f) ds *= 1.f - t * t;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int KVH, Mask mask) {
  constexpr int B = Tile<D>::B, TM = B / 16, DC = D / 16, DP = D + 1, SP = B + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + B * DP;
  float* Qs = Vs + B * DP;
  float* Os = Qs + B * DP;  // dO
  float* Ps = Os + B * DP;
  float* Ss = Ps + B * SP;  // dS
  float* lse_s = Ss + B * SP;
  float* del_s = lse_s + B;

  const int Sq = mask.Sq, Skv = mask.Skv;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * B;
  const int b = blockIdx.y / KVH, kvh = blockIdx.y % KVH;
  const int group = H / KVH;
  const size_t q_row = static_cast<size_t>(H) * D, kv_row = static_cast<size_t>(KVH) * D;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;
  load_tile<T, D, B>(Ks, k + kv_off, kv_row, k0, Skv);
  load_tile<T, D, B>(Vs, v + kv_off, kv_row, k0, Skv);

  float dk_acc[TM][DC], dv_acc[TM][DC];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // the query rows that see a key of this tile: from the first that the
  // causal mask lets see key k0, to the last that the window lets see key
  // k0 + B - 1
  int i_lo = 0, i_hi = Sq - 1;
  if (mask.causal) i_lo = max(0, k0 - mask.q_offset);
  if (mask.window > 0) i_hi = min(i_hi, k0 + B - 2 + mask.window - mask.q_offset);
  const int qt_lo = i_lo <= i_hi ? i_lo / B : 1, qt_hi = i_lo <= i_hi ? i_hi / B : 0;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const size_t q_off = static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
    const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * B;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D, B>(Qs, q + q_off, q_row, q0, Sq);
      load_tile<T, D, B>(Os, dout + q_off, q_row, q0, Sq);
      for (int r = tid; r < B; r += NT) {
        lse_s[r] = q0 + r < Sq ? lse[row_off + q0 + r] : 0.f;
        del_s[r] = q0 + r < Sq ? delta[row_off + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[TM][TM], dp[TM][TM];
      score_tiles<D, B>(Qs, Os, Ks, Vs, ty, tx, s, dp);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int row = ty * TM + r;
#pragma unroll
        for (int c = 0; c < TM; ++c) {
          const int col = tx + 16 * c;
          float p, ds;
          mask.grads(s[r][c], dp[r][c], lse_s[row], del_s[row], q0 + row, k0 + col, p, ds);
          Ps[row * SP + col] = p;
          Ss[row * SP + col] = ds;
        }
      }
      __syncthreads();

      // dv += P^T dO and dk += dS^T Q for keys ty * TM + r, columns tx + 16 c
#pragma unroll 2
      for (int i = 0; i < B; ++i) {
        float pv[TM], sv[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          pv[r] = Ps[i * SP + ty * TM + r];
          sv[r] = Ss[i * SP + ty * TM + r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float o = Os[i * DP + tx + 16 * c];
          const float qq = Qs[i * DP + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            dv_acc[r][c] = fmaf(pv[r], o, dv_acc[r][c]);
            dk_acc[r][c] = fmaf(sv[r], qq, dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int key = k0 + ty * TM + r;
    if (key >= Skv) continue;
    const size_t off = kv_off + static_cast<size_t>(key) * kv_row;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(dk_acc[r][c] * mask.sm_scale);
      dv[off + tx + 16 * c] = from_f<T>(dv_acc[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int KVH, Mask mask) {
  constexpr int B = Tile<D>::B, TM = B / 16, DC = D / 16, DP = D + 1, SP = B + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + B * DP;
  float* Qs = Vs + B * DP;
  float* Os = Qs + B * DP;  // dO
  float* Ss = Os + B * DP;  // dS
  float* lse_s = Ss + B * SP;
  float* del_s = lse_s + B;

  const int Sq = mask.Sq, Skv = mask.Skv;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * B;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const size_t q_row = static_cast<size_t>(H) * D, kv_row = static_cast<size_t>(KVH) * D;
  const size_t q_off = static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;
  const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
  load_tile<T, D, B>(Qs, q + q_off, q_row, q0, Sq);
  load_tile<T, D, B>(Os, dout + q_off, q_row, q0, Sq);
  for (int r = tid; r < B; r += NT) {
    lse_s[r] = q0 + r < Sq ? lse[row_off + q0 + r] : 0.f;
    del_s[r] = q0 + r < Sq ? delta[row_off + q0 + r] : 0.f;
  }

  float dq_acc[TM][DC];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[r][c] = 0.f;

  // the KV tiles this query tile's mask reaches
  const int first_q = mask.q_offset + q0;
  const int nk = (Skv + B - 1) / B;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * B;
    if (mask.causal && k0 > first_q + B - 1) continue;
    if (mask.window > 0 && k0 + B - 1 <= first_q - mask.window) continue;
    __syncthreads();  // the previous tile's readers are done (and Q, dO are loaded)
    load_tile<T, D, B>(Ks, k + kv_off, kv_row, k0, Skv);
    load_tile<T, D, B>(Vs, v + kv_off, kv_row, k0, Skv);
    __syncthreads();

    float s[TM][TM], dp[TM][TM];
    score_tiles<D, B>(Qs, Os, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = ty * TM + r;
#pragma unroll
      for (int c = 0; c < TM; ++c) {
        const int col = tx + 16 * c;
        float p, ds;
        mask.grads(s[r][c], dp[r][c], lse_s[row], del_s[row], q0 + row, k0 + col, p, ds);
        Ss[row * SP + col] = ds;
      }
    }
    __syncthreads();

    // dq += dS K for rows ty * TM + r, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < B; ++j) {
      float sv[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) sv[r] = Ss[(ty * TM + r) * SP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = Ks[j * DP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < TM; ++r) dq_acc[r][c] = fmaf(sv[r], kk, dq_acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = q0 + ty * TM + r;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[q_off + static_cast<size_t>(row) * q_row + tx + 16 * c] =
          from_f<T>(dq_acc[r][c] * mask.sm_scale);
  }
}

template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, const T* out, const T* dout,
                   const float* lse, float* delta, T* dq, T* dk, T* dv, int Bn, int H, int KVH,
                   const Mask& mask, cudaStream_t stream) {
  constexpr int B = Tile<D>::B;
  const size_t rows = static_cast<size_t>(Bn) * mask.Sq * H;
  const size_t delta_blocks = (rows + NT / 32 - 1) / (NT / 32);
  const int nq = (mask.Sq + B - 1) / B, nk = (mask.Skv + B - 1) / B;
  if (delta_blocks > 0x7fffffffu || Bn * H > 65535) return cudaErrorInvalidValue;
  bwd_delta_kernel<T><<<static_cast<unsigned>(delta_blocks), NT, 0, stream>>>(out, dout, delta,
                                                                           mask.Sq, H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = bwd_dkdv_kernel<T, D>;
  const size_t smem_kv = smem_bytes<D>(2);
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(nk, Bn * KVH), NT, smem_kv, stream>>>(q, k, v, dout, lse, delta, dk, dv, H, KVH,
                                                    mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_kernel<T, D>;
  const size_t smem_q = smem_bytes<D>(1);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  dqk<<<dim3(nq, Bn * H), NT, smem_q, stream>>>(q, k, v, dout, lse, delta, dq, H, KVH, mask);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int Bn, int H, int KVH, const Mask& mask, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (dtype == kFloat32)
    return launch<float, D>(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<const float*>(out),
                            static_cast<const float*>(dout), lse, delta,
                            static_cast<float*>(dq), static_cast<float*>(dk),
                            static_cast<float*>(dv), Bn, H, KVH, mask, st);
  if (dtype == kBFloat16)
    return launch<bf16, D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<const bf16*>(out),
                           static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), Bn, H, KVH, mask,
                           st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launches (0 on success); the wrapper raises on
// anything else. The caller checks shapes, dtypes, devices, alignment and
// contiguity, and allocates dq, dk, dv and the fp32 `delta` scratch (B, H, Sq).
// Head dims are the forward kernel's: 32-256 in both dtypes, 16 in fp32.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Sq, int Skv, int H,
                                   int KVH, int D, int causal, int window, int q_offset,
                                   float sm_scale, float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{Sq, Skv, causal, window, q_offset, sm_scale, softcap};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 16:  // the smoke configs' head dim: fp32 only, as the forward kernel
      if (dtype != kFloat32) return cudaErrorInvalidValue;
      return launch_d<16>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, H, KVH, mask, st);
    case 32:
      return launch_d<32>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, H, KVH, mask, st);
    case 64:
      return launch_d<64>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, H, KVH, mask, st);
    case 128:
      return launch_d<128>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, H, KVH, mask, st);
    case 256:
      return launch_d<256>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, H, KVH, mask, st);
    default:
      return cudaErrorInvalidValue;
  }
}
