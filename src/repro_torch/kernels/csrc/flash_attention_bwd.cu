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
// dtype; p, ds and every sum are fp32.
//
// No kernel here has an atomic, so the result is the same bit for bit from
// run to run (the trainer's crash-and-resume check relies on it): every
// output element is written by one block, and a sum across blocks is a
// separate pass in a fixed order. Kernels, on the caller's stream:
//   1. delta = sum_d dout * out, a row's 16-byte chunks over neighbouring lanes.
//   2. dk, dv: a block per (key tile, batch x kv head x head split), the key
//      tiles on the grid's slow axis so that the heaviest causal tiles start
//      first. It keeps its K and V tiles in shared memory and its dk, dv tiles
//      in registers, and walks the query heads of its share of the GQA group
//      and, for each, the query tiles its mask can reach (all of them without
//      a mask; under causal and window only those rows that see a key of the
//      tile), recomputing S and dP a tile at a time: dv += P^T dO, dk += dS^T Q.
//   3. with `splits` > 1 (the wrapper's plan, kernels/flash_attention.py
//      `_bwd_plan`: the smallest divisor of the group that gives the dk/dv
//      grid a block for each of the 132 SMs, else the group), each head split
//      writes fp32 partials into the wrapper's scratch, (2, splits, B, Skv,
//      KVH, D), and a reduce kernel sums them in split order and casts.
//   4. dq: a block per (query tile, batch x head), looping over the KV tiles
//      its mask reaches, recomputing S and dP: dq += dS K.
// S and dP are thus computed twice (seven products where five would do): the
// one-pass form needs either fp32 dq partials per key tile (67 MB at
// llama3.2-1b's training shape, more than the whole of its bytes bound) or an
// ordered sum across blocks.
// Rows and keys past Sq and Skv are zero-filled in shared memory and masked.
// A query row that no key is visible to (lse = kNegInf) gets p = 0 from the
// explicit mask, so it adds nothing (its forward row is zeros;
// csrc/flash_attention.cu); exp(kNegInf - kNegInf) would give 1.
//
// What bounds it on the H100: at llama3.2-1b's training shape (q (8,256,32,64),
// k/v (8,256,8,64), causal, bf16) the five products over the 8.4 M kept
// (query, key) pairs are 5.4 GFLOP, 5.5 us at 989 TFLOP/s bf16, against
// 42 MB of q, k, v, out, dout, lse, dq, dk, dv, 12.6 us at 3.35 TB/s: the
// bytes bound it, and both are small, so what a design has to cut is the
// time each tile waits on its loads and on its dependent products, and the
// causal mask's uneven work (the first key tile sees every query tile).
//
// * bf16: tensor cores, the forward kernel's FlashAttention-2 form turned
//   round. A dk/dv block holds its K and V tiles in shared memory as bf16
//   (rows padded by 16 bytes so ldmatrix reads no bank twice); each (head,
//   query tile) it visits streams its Q and dO tiles, with their rows' lse
//   and delta, through a double-buffered cp.async ring (tile i+1 loads while
//   tile i is multiplied). Its warps own 16-key stripes; each computes
//   S^T = K Q^T and dP^T = V dO^T with mma.sync m16n8k16 (K and V the A
//   operand by ldmatrix, Q and dO the B operand), applies scale, softcap, the
//   mask and p = 2^(x log2 e - lse log2 e) on the fragments in registers (a
//   warp whose pairs are all visible skips the mask), takes
//   ds^T = p^T (dp^T - delta), and feeds P^T and dS^T, packed to bf16, as the
//   A operand of dV += P^T dO and dK += dS^T Q straight from registers, dO
//   and Q through ldmatrix .trans: no score tile goes to shared memory. The
//   16 x D dk and dv accumulators and the score tiles have to fit a thread's
//   registers (`Mma<D>`): at D <= 64 a block is 32 keys, two stripes whose
//   64-row query tile is split over two warps each (their partial dk and dv
//   summed in shared memory at the end, in a fixed order), held to 3 blocks
//   an SM; at D = 128 64 keys, 4 warps, 32-row query tiles; at D = 256 also
//   two warps a stripe, each taking half of D's columns and computing the
//   stripe's scores itself (8 warps). The dq block (64 query rows, 16 a warp,
//   3 blocks an SM at D <= 64) keeps Q and dO in shared memory, streams K and
//   V tiles (64 keys, 32 at D = 256) through a cp.async ring, and computes
//   S = Q K^T, dP = dO V^T and dq += dS K the same way, dS from registers and
//   K through ldmatrix .trans. A third or fourth ring stage measured no
//   faster, and splitting the training shape's group over blocks slower
//   (the reduce costs more than the balance gains).
//   Rounding P and dS to bf16 is a rounding the plain version does not make:
//   at the [kernel-bwd] cases the gradients are 2.6e-3 to 2.9e-3 from the
//   plain backward in relative norm, against 1.6e-3 to 1.7e-3 with fp32 P and
//   dS, under the 1e-2 tolerance. ptxas: dk/dv 129-167 registers at D <= 64,
//   239-241 above; dq 159-164 and 236-247; no spills.
// * fp32: CUDA-core FMAs in fp32 from shared-memory tiles (each thread a 4x4
//   block of a 64x64 product, or of the 64 x D gradient tile in columns 16
//   apart, so that rows padded by one float keep the lanes on distinct
//   banks), tiles read 16 bytes a lane; TF32 would not hold the fp32
//   tolerance. 64-row tiles at head dims 16-128, 32 at D = 256, where four
//   64-row fp32 tiles of 257 floats would not fit the 227 KB a block may have.
//   It takes the same head split and grid order.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py
// [kernel-bwd]; PERF.md section 6 has every row): at the training
// shape in bf16 0.0772 ms warm, 0.0842 with L2 flushed (delta 0.0060, dk/dv
// 0.0364, dq 0.0284), against 0.566 ms for the CUDA-core design before it,
// the library's backward at 0.100 and the bound at 0.0126; the MQA case at
// D = 256 (8 heads over one kv head, 200 keys) 0.0586, against 1.07 before;
// fp32 0.457 and 0.214 (0.581 and 1.27 before).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads of the CUDA-core blocks: a 16 x 16 grid
constexpr float kLog2e = 1.4426950408889634f;

// 2^x; very negative x gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte global -> shared copy; with `valid` false the 4 bytes are zero-filled
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

struct Mask {
  int Sq, Skv, causal, window, q_offset;
  float sm_scale, softcap;

  // whether query row qi sees key kp
  __device__ __forceinline__ bool visible(int qi, int kp) const {
    const int qp = q_offset + qi;
    bool ok = kp < Skv && qi < Sq;
    if (causal) ok = ok && kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
    return ok;
  }

  // p and ds of one (query row qi, key kp) pair from its raw score and dP
  __device__ __forceinline__ void grads(float raw, float dpv, float lse, float delta, int qi,
                                        int kp, float& p, float& ds) const {
    float x = raw * sm_scale, t = 0.f;
    if (softcap > 0.f) {
      t = tanhf(x / softcap);
      x = t * softcap;
    }
    p = visible(qi, kp) ? expf(x - lse) : 0.f;
    ds = p * (dpv - delta);
    if (softcap > 0.f) ds *= 1.f - t * t;
  }

  // the same in log2 units for the tensor-core kernels: lse2 is the row's lse
  // times log2 e; `check` false skips the mask (a tile seen whole). The mask
  // comes before the exp: a row no key is visible to has lse2 = kNegInf
  // log2 e, and its masked scores would give 2^0 = 1
  __device__ __forceinline__ void grads2(float raw, float dpv, float lse2, float delta, int qi,
                                         int kp, bool check, float& p, float& ds) const {
    float x, t = 0.f;
    if (softcap > 0.f) {
      t = tanhf(raw * (sm_scale / softcap));
      x = t * (softcap * kLog2e);
    } else {
      x = raw * (sm_scale * kLog2e);
    }
    p = !check || visible(qi, kp) ? ex2(x - lse2) : 0.f;
    ds = p * (dpv - delta);
    if (softcap > 0.f) ds *= 1.f - t * t;
  }
};

// The query rows that see a key of the key tile [k0, k0 + bk): from the first
// that the causal mask lets see key k0 to the last that the window lets see
// key k0 + bk - 1; as tiles of bq rows, [*lo, *lo + *n)
__device__ __forceinline__ void query_tiles(const Mask& m, int k0, int bk, int bq, int* lo,
                                            int* n) {
  int i_lo = 0, i_hi = m.Sq - 1;
  if (m.causal) i_lo = max(0, k0 - m.q_offset);
  if (m.window > 0) i_hi = min(i_hi, k0 + bk - 2 + m.window - m.q_offset);
  *lo = i_lo <= i_hi ? i_lo / bq : 0;
  *n = i_lo <= i_hi ? i_hi / bq - i_lo / bq + 1 : 0;
}

// The key tiles of bk keys that the query rows [q0, q0 + bq) reach: [*lo, *hi]
__device__ __forceinline__ void key_tiles(const Mask& m, int q0, int bq, int bk, int* lo,
                                          int* hi) {
  const int first_q = m.q_offset + q0;
  *lo = 0;
  *hi = (m.Skv + bk - 1) / bk - 1;
  if (m.causal) *hi = min(*hi, (first_q + bq - 1) / bk);
  // skip tiles whose last key is at or before first_q - window
  if (m.window > 0) {
    const int last_out = first_q - m.window;  // the highest key no row of the tile sees
    if (last_out >= 0) *lo = max(*lo, (last_out + 1) / bk);
  }
}

// the sum of the products of two 16-byte chunks of T
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a), y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
}
__device__ __forceinline__ float dot16(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x2[i]), w = __bfloat1622float2(y2[i]);
    s = fmaf(u.x, w.x, fmaf(u.y, w.y, s));
  }
  return s;
}

// delta[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d]: rows read 16
// bytes a lane, L lanes a row (a warp takes 32 / L rows)
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
    int Sq, int H, size_t rows) {
  constexpr int E = 16 / sizeof(T);             // elements a chunk
  constexpr int CHUNKS = D / E;                 // chunks a row
  constexpr int L = CHUNKS < 32 ? CHUNKS : 32;  // lanes a row, a power of 2
  const size_t row = (static_cast<size_t>(blockIdx.x) * NT + threadIdx.x) / L;
  const int sub = threadIdx.x % L;
  float s = 0.f;
  if (row < rows) {
#pragma unroll
    for (int c = sub; c < CHUNKS; c += L) s += dot16(dout + row * D + c * E, out + row * D + c * E);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && sub == 0) {
    const int h = static_cast<int>(row % H);
    const size_t bi = row / H;  // b * Sq + i
    const size_t b = bi / Sq;
    delta[(b * H + h) * Sq + bi % Sq] = s;
  }
}

// dk = scale * sum_s part[0, s], dv = sum_s part[1, s], over the splits in
// order; four elements a thread (n, the elements of dk, is a multiple of 4)
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 x);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
template <>
__device__ __forceinline__ void store4<bf16>(bf16* dst, float4 x) {
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  d2[0] = __floats2bfloat162_rn(x.x, x.y);
  d2[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename T>
__global__ void __launch_bounds__(NT) bwd_reduce_kernel(const float* __restrict__ part,
                                                        T* __restrict__ dk, T* __restrict__ dv,
                                                        size_t n, int splits, float sm_scale) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * NT + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const size_t j = is_v ? i - n : i;
  const float* src = part + (is_v ? static_cast<size_t>(splits) * n : 0) + j;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(s) * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  if (!is_v) {
    acc.x *= sm_scale;
    acc.y *= sm_scale;
    acc.z *= sm_scale;
    acc.w *= sm_scale;
  }
  store4<T>((is_v ? dv : dk) + j, acc);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs from shared-memory tiles

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

// a B x D tile of a (rows, heads, D) fp32 tensor into shared memory, rows
// padded to D + 1, read 16 bytes a lane; rows at or past `n` are zero. A
// warp reads 128 contiguous bytes of each of 4 rows (D >= 32), so that the
// four scalar stores of a lane land on 32 distinct banks (D + 1 = 1 mod 32)
template <int D, int B>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t row_stride,
                                          int r0, int n) {
  constexpr int C4 = D / 4;                 // 16-byte chunks a row
  constexpr int LPR = C4 < 8 ? C4 : 8;      // lanes a row
  for (int i = threadIdx.x; i < B * C4; i += NT) {
    const int band = i / (B * LPR), rem = i % (B * LPR);
    const int r = rem / LPR, c = (band * LPR + rem % LPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * row_stride + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
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

template <int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ part, int H, int KVH, int splits, Mask mask) {
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
  const int k0 = blockIdx.y * B;  // the heaviest causal tiles first
  const int sp = blockIdx.x % splits, bk = blockIdx.x / splits;
  const int b = bk / KVH, kvh = bk % KVH;
  const int group = H / KVH, per = group / splits;
  const size_t q_row = static_cast<size_t>(H) * D, kv_row = static_cast<size_t>(KVH) * D;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;
  load_tile<D, B>(Ks, k + kv_off, kv_row, k0, Skv);
  load_tile<D, B>(Vs, v + kv_off, kv_row, k0, Skv);

  float dk_acc[TM][DC], dv_acc[TM][DC];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  int qt_lo, nqt;
  query_tiles(mask, k0, B, B, &qt_lo, &nqt);

  for (int hh = sp * per; hh < (sp + 1) * per; ++hh) {
    const int h = kvh * group + hh;
    const size_t q_off = static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
    const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = qt_lo; qt < qt_lo + nqt; ++qt) {
      const int q0 = qt * B;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D, B>(Qs, q + q_off, q_row, q0, Sq);
      load_tile<D, B>(Os, dout + q_off, q_row, q0, Sq);
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

  // one split: the gradients; several: this split's fp32 partials
  const size_t n = static_cast<size_t>(gridDim.x / (KVH * splits)) * Skv * kv_row;
  float* pk = part + static_cast<size_t>(sp) * n;
  float* pv = pk + static_cast<size_t>(splits) * n;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int key = k0 + ty * TM + r;
    if (key >= Skv) continue;
    const size_t off = kv_off + static_cast<size_t>(key) * kv_row;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      if (splits == 1) {
        dk[off + tx + 16 * c] = dk_acc[r][c] * mask.sm_scale;
        dv[off + tx + 16 * c] = dv_acc[r][c];
      } else {
        pk[off + tx + 16 * c] = dk_acc[r][c];
        pv[off + tx + 16 * c] = dv_acc[r][c];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int KVH, Mask mask) {
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
  load_tile<D, B>(Qs, q + q_off, q_row, q0, Sq);
  load_tile<D, B>(Os, dout + q_off, q_row, q0, Sq);
  for (int r = tid; r < B; r += NT) {
    lse_s[r] = q0 + r < Sq ? lse[row_off + q0 + r] : 0.f;
    del_s[r] = q0 + r < Sq ? delta[row_off + q0 + r] : 0.f;
  }

  float dq_acc[TM][DC];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[r][c] = 0.f;

  int kt_lo, kt_hi;
  key_tiles(mask, q0, B, B, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * B;
    __syncthreads();  // the previous tile's readers are done (and Q, dO are loaded)
    load_tile<D, B>(Ks, k + kv_off, kv_row, k0, Skv);
    load_tile<D, B>(Vs, v + kv_off, kv_row, k0, Skv);
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
      dq[q_off + static_cast<size_t>(row) * q_row + tx + 16 * c] = dq_acc[r][c] * mask.sm_scale;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async double-buffered rings

constexpr int BQD = 64;  // query rows per dq block, 16 a warp

// The dk/dv block: STRIPES stripes of 16 keys; each stripe's query tile is
// split over QS warps (WQ queries each, their dk and dv partials summed in
// shared memory at the end) and its D columns over PAIR warps (each computing
// the stripe's scores itself)
template <int D>
struct Mma {
  static constexpr int STRIPES = D <= 64 ? 2 : 4;
  static constexpr int QS = D <= 64 ? 2 : 1;
  static constexpr int PAIR = D == 256 ? 2 : 1;
  static constexpr int BKV = 16 * STRIPES;         // keys of a dk/dv block
  static constexpr int NW = STRIPES * QS * PAIR;   // warps of a dk/dv block
  static constexpr int WD = D / PAIR;              // gradient columns of a warp
  static constexpr int BQ = D <= 64 ? 64 : 32;     // query rows a dk/dv tile
  static constexpr int WQ = BQ / QS;               // of them, a warp's
  static constexpr int BK = D == 256 ? 32 : 64;    // keys a dq tile
  static constexpr int LD = D + 8;                 // shared-memory row stride, elements
  // stages of the Q/dO ring (dk/dv) and of the K/V ring (dq)
  static constexpr int kStages = 2;
  static constexpr int kDqStages = 2;
  // blocks an SM that ptxas must fit in registers
  static constexpr int kDkdvMinBlocks = D <= 64 ? 3 : 1;
  static constexpr int kDqMinBlocks = D <= 64 ? 3 : 1;
  static constexpr size_t dkdv_smem = static_cast<size_t>(2 * BKV + 2 * kStages * BQ) * LD *
                                          sizeof(bf16) +
                                      2 * kStages * BQ * sizeof(float);
  static constexpr size_t dq_smem =
      static_cast<size_t>(2 * BQD + 2 * kDqStages * BK) * LD * sizeof(bf16);
  // the QS - 1 partner warps' dk and dv fragments go through the Q/dO ring
  static_assert((QS - 1) * STRIPES * PAIR * 2 * (WD / 8) * 4 * 32 * sizeof(float) <=
                    2 * kStages * BQ * LD * sizeof(bf16),
                "the partials' exchange must fit the Q/dO ring");
};

template <int D>
__global__ void __launch_bounds__(Mma<D>::NW * 32, Mma<D>::kDkdvMinBlocks) bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ part, int H, int KVH, int splits, Mask mask) {
  using C = Mma<D>;
  constexpr int NTM = C::NW * 32, BKV = C::BKV, BQ = C::BQ, WQ = C::WQ, LD = C::LD;
  constexpr int NS = C::kStages;
  constexpr int CH = D / 8;         // 16-byte chunks per row
  constexpr int KD = D / 16;        // k-steps of the score products
  constexpr int NQ = WQ / 8;        // score n-tiles (8 queries each) of a warp
  constexpr int NG = C::WD / 8;     // gradient n-tiles (8 columns each) of a warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;      // NS stages
  bf16* Os = Qs + NS * BQ * LD;  // dO, NS stages
  float* lse_s = reinterpret_cast<float*>(Os + NS * BQ * LD);  // NS stages
  float* del_s = lse_s + NS * BQ;

  const int Sq = mask.Sq, Skv = mask.Skv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row and column pair
  // warp = (stripe * QS + query part) * PAIR + column part
  const int stripe = warp / (C::QS * C::PAIR), qpart = warp / C::PAIR % C::QS;
  const int col0 = warp % C::PAIR * C::WD, qc0 = qpart * WQ;
  const int k0 = blockIdx.y * BKV;  // the heaviest causal tiles first
  const int sp = blockIdx.x % splits, bk = blockIdx.x / splits;
  const int b = bk / KVH, kvh = bk % KVH;
  const int group = H / KVH, per = group / splits;
  const size_t q_row = static_cast<size_t>(H) * D, kv_row = static_cast<size_t>(KVH) * D;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;

  int qt_lo, nqt;
  query_tiles(mask, k0, BKV, BQ, &qt_lo, &nqt);
  const int items = per * nqt;  // (head, query tile) pairs, head-major

  auto load_q = [&](int item, int stage) {
    const int h = kvh * group + sp * per + item / nqt;
    const int q0 = (qt_lo + item % nqt) * BQ;
    const size_t q_off = static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
    bf16* qd = Qs + stage * BQ * LD;
    bf16* od = Os + stage * BQ * LD;
    for (int i = tid; i < BQ * CH; i += NTM) {
      const int r = i / CH, c = i % CH;
      const bool in = q0 + r < Sq;  // rows past Sq are zero
      const size_t off = q_off + (in ? static_cast<size_t>(q0 + r) * q_row + c * 8 : 0);
      cp_async_16(qd + r * LD + c * 8, q + off, in);
      cp_async_16(od + r * LD + c * 8, dout + off, in);
    }
    const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
    for (int r = tid; r < BQ; r += NTM) {
      const bool in = q0 + r < Sq;
      const size_t off = row_off + (in ? q0 + r : 0);
      cp_async_4(lse_s + stage * BQ + r, lse + off, in);
      cp_async_4(del_s + stage * BQ + r, delta + off, in);
    }
  };

  if (items > 0) {
    for (int i = tid; i < BKV * CH; i += NTM) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < Skv;  // rows past Skv are zero
      const size_t off = kv_off + (in ? static_cast<size_t>(k0 + r) * kv_row + c * 8 : 0);
      cp_async_16(Ks + r * LD + c * 8, k + off, in);
      cp_async_16(Vs + r * LD + c * 8, v + off, in);
    }
  }
  // groups 0 .. NS - 2 hold items 0 .. NS - 2 (group 0 K and V too), maybe empty
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < items) load_q(i, i);
    cp_async_commit();
  }

  float dk_acc[NG][4], dv_acc[NG][4];
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int key_w = k0 + stripe * 16;  // the warp's first key
  const bf16* k_frag = Ks + (stripe * 16 + lane % 16) * LD + (lane / 16) * 8;
  const bf16* v_frag = Vs + (stripe * 16 + lane % 16) * LD + (lane / 16) * 8;
  for (int it = 0; it < items; ++it) {
    const int stage = it % NS;
    // item it + NS - 1 into the stage item it - 1 left: group NS - 1 + it
    if (it + NS - 1 < items) load_q(it + NS - 1, (it + NS - 1) % NS);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // groups 0 .. it are in
    __syncthreads();  // item it (and on the first pass K, V) is in shared memory

    const int q0 = (qt_lo + it % nqt) * BQ;
    const bf16* Qt = Qs + stage * BQ * LD;
    const bf16* Ot = Os + stage * BQ * LD;
    const float* lt = lse_s + stage * BQ;
    const float* dt = del_s + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and WQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, k_frag + kk * 16);
      ldmatrix_x4(va, v_frag + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NQ / 2; ++jp) {
        const int off = (qc0 + jp * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8;
        uint32_t qb[4], ob[4];
        ldmatrix_x4(qb, Qt + off);
        ldmatrix_x4(ob, Ot + off);
        mma_bf16_16816(s[2 * jp], ka, qb[0], qb[1]);
        mma_bf16_16816(s[2 * jp + 1], ka, qb[2], qb[3]);
        mma_bf16_16816(dp[2 * jp], va, ob[0], ob[1]);
        mma_bf16_16816(dp[2 * jp + 1], va, ob[2], ob[3]);
      }
    }

    // p^T and ds^T in place of s and dp. Element e of n-tile j is key
    // key_w + g + 8 * (e / 2), query q0 + qc0 + 8 * j + 2 * t + e % 2. A warp
    // whose every (key, query) pair is visible skips the mask.
    const int wq = q0 + qc0;  // the warp's first query row
    const bool whole = key_w + 15 < Skv && wq + WQ - 1 < Sq &&
                       (!mask.causal || key_w + 15 <= mask.q_offset + wq) &&
                       (mask.window <= 0 || key_w > mask.q_offset + wq + WQ - 1 - mask.window);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + qc0 + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + qc0 + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = qc0 + 8 * j + 2 * t + e % 2;
        float p, ds;
        mask.grads2(s[j][e], dp[j][e], (e % 2 ? l2.y : l2.x) * kLog2e, e % 2 ? d2.y : d2.x,
                    q0 + col, key_w + g + 8 * (e / 2), !whole, p, ds);
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }

    // dV += P^T dO and dK += dS^T Q over the warp's queries and columns: the
    // fragments of two score n-tiles are the A fragment of one 16-query step,
    // rounded to bf16
#pragma unroll
    for (int kk = 0; kk < WQ / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {
          pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NG / 2; ++np) {
        const int off = (qc0 + kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + col0 +
                        np * 16 + (lane / 16) * 8;
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, Ot + off);
        ldmatrix_x4_trans(qb, Qt + off);
        mma_bf16_16816(dv_acc[2 * np], pa, ob[0], ob[1]);
        mma_bf16_16816(dv_acc[2 * np + 1], pa, ob[2], ob[3]);
        mma_bf16_16816(dk_acc[2 * np], da, qb[0], qb[1]);
        mma_bf16_16816(dk_acc[2 * np + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // the query parts' dk and dv summed in order: parts 1.. put their fragments
  // in the Q/dO ring (idle after the loop's last barrier), part 0 adds them
  if (C::QS > 1) {
    float* xch = reinterpret_cast<float*>(Qs);
    constexpr int SLOT = 2 * NG * 4 * 32;  // floats a warp's fragments
    const int pair_id = stripe * C::PAIR + warp % C::PAIR;
    if (qpart > 0) {
      float* dst = xch + ((qpart - 1) * C::STRIPES * C::PAIR + pair_id) * SLOT + lane;
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[(n * 4 + e) * 32] = dk_acc[n][e];
          dst[((NG + n) * 4 + e) * 32] = dv_acc[n][e];
        }
    }
    __syncthreads();
    if (qpart > 0) return;
    for (int pq = 1; pq < C::QS; ++pq) {
      const float* src = xch + ((pq - 1) * C::STRIPES * C::PAIR + pair_id) * SLOT + lane;
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk_acc[n][e] += src[(n * 4 + e) * 32];
          dv_acc[n][e] += src[((NG + n) * 4 + e) * 32];
        }
    }
  }

  // element e of n-tile n is key key_w + g + 8 * (e / 2), column
  // col0 + 8 * n + 2 * t + e % 2. One split: the gradients; several: this
  // split's fp32 partials
  const size_t n_el = static_cast<size_t>(gridDim.x / (KVH * splits)) * Skv * kv_row;
  float* pk = part + static_cast<size_t>(sp) * n_el;
  float* pv = pk + static_cast<size_t>(splits) * n_el;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_w + g + 8 * r;
    if (key >= Skv) continue;
    const size_t row = kv_off + static_cast<size_t>(key) * kv_row + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const size_t off = row + 8 * n;
      if (splits == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
            dk_acc[n][2 * r] * mask.sm_scale, dk_acc[n][2 * r + 1] * mask.sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      } else {
        *reinterpret_cast<float2*>(pk + off) = make_float2(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
        *reinterpret_cast<float2*>(pv + off) = make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BQD * 2, Mma<D>::kDqMinBlocks) bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int KVH, Mask mask) {
  using C = Mma<D>;
  constexpr int NTM = BQD * 2, BK = C::BK, LD = C::LD, NST = C::kDqStages;
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KD = D / 16;  // k-steps of the score products
  constexpr int NS = BK / 8;  // score n-tiles (8 keys each)
  constexpr int ND = D / 8;   // dq n-tiles (8 columns each)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + BQD * LD;     // dO
  bf16* Ks = Os + BQD * LD;       // NST stages
  bf16* Vs = Ks + NST * BK * LD;  // NST stages

  const int Sq = mask.Sq, Skv = mask.Skv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQD;  // heaviest causal tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const size_t q_row = static_cast<size_t>(H) * D, kv_row = static_cast<size_t>(KVH) * D;
  const size_t q_off = static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;

  int kt_lo, kt_hi;
  key_tiles(mask, q0, BQD, BK, &kt_lo, &kt_hi);

  auto load_kv = [&](int kt, int stage) {
    bf16* kd = Ks + stage * BK * LD;
    bf16* vd = Vs + stage * BK * LD;
    for (int i = tid; i < BK * CH; i += NTM) {
      const int r = i / CH, c = i % CH;
      const int key = kt * BK + r;
      const bool in = key < Skv;  // rows past Skv are zero
      const size_t off = kv_off + (in ? static_cast<size_t>(key) * kv_row + c * 8 : 0);
      cp_async_16(kd + r * LD + c * 8, k + off, in);
      cp_async_16(vd + r * LD + c * 8, v + off, in);
    }
  };

  if (kt_lo <= kt_hi) {
    for (int i = tid; i < BQD * CH; i += NTM) {
      const int r = i / CH, c = i % CH;
      const bool in = q0 + r < Sq;
      const size_t off = q_off + (in ? static_cast<size_t>(q0 + r) * q_row + c * 8 : 0);
      cp_async_16(Qs + r * LD + c * 8, q + off, in);
      cp_async_16(Os + r * LD + c * 8, dout + off, in);
    }
  }
  // groups 0 .. NST - 2 hold tiles kt_lo .. kt_lo + NST - 2 (group 0 Q and dO too)
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (kt_lo + i <= kt_hi) load_kv(kt_lo + i, i);
    cp_async_commit();
  }

  // this thread's rows: wr + g and wr + g + 8
  const int wr = q0 + warp * 16;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    const size_t off = (static_cast<size_t>(b) * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse[off] * kLog2e : 0.f;
    del[r] = row < Sq ? delta[off] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int a_off = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) % NST;
    if (kt + NST - 1 <= kt_hi) load_kv(kt + NST - 1, (kt - kt_lo + NST - 1) % NST);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();  // tile kt (and on the first pass Q, dO) is in shared memory

    const bf16* Kt = Ks + stage * BK * LD;
    const bf16* Vt = Vs + stage * BK * LD;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows and the tile's keys; Q's
    // and dO's fragments come from shared memory at each k-step (kept in
    // registers, they would cost the block its third block an SM)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      ldmatrix_x4(qa, Qs + a_off + kk * 16);
      ldmatrix_x4(oa, Os + a_off + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        const int off = (jp * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8;
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, Kt + off);
        ldmatrix_x4(vb, Vt + off);
        mma_bf16_16816(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16_16816(s[2 * jp + 1], qa, kb[2], kb[3]);
        mma_bf16_16816(dp[2 * jp], oa, vb[0], vb[1]);
        mma_bf16_16816(dp[2 * jp + 1], oa, vb[2], vb[3]);
      }
    }

    // ds in place of dp. Element e of n-tile j is row wr + g + 8 * (e / 2),
    // key kt * BK + 8 * j + 2 * t + e % 2. A tile that every row of the warp
    // sees whole skips the mask.
    const int k_first = kt * BK, k_last = k_first + BK - 1;
    const bool whole = k_last < Skv && wr + 15 < Sq &&
                       (!mask.causal || k_last <= mask.q_offset + wr) &&
                       (mask.window <= 0 || k_first > mask.q_offset + wr + 15 - mask.window);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p, ds;
        mask.grads2(s[j][e], dp[j][e], lse2[e / 2], del[e / 2], wr + g + 8 * (e / 2),
                    k_first + 8 * j + 2 * t + e % 2, !whole, p, ds);
        dp[j][e] = ds;
      }
    }

    // dq += dS K: dS from registers, rounded to bf16; K through ldmatrix .trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t da[4] = {
          pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, Kt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                                  np * 16 + (lane / 16) * 8);
        mma_bf16_16816(acc[2 * np], da, kb[0], kb[1]);
        mma_bf16_16816(acc[2 * np + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // dq = scale * acc, staged through the warp's own Q rows so that the stores
  // to device memory are 16 bytes a lane
  bf16* St = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(St + g * LD + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] * mask.sm_scale, acc[n][1] * mask.sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(St + (g + 8) * LD + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] * mask.sm_scale, acc[n][3] * mask.sm_scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const int row = wr + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(dq + q_off + static_cast<size_t>(row) * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(St + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// launches

template <typename T, int D>
cudaError_t launch_delta(const T* out, const T* dout, float* delta, int Bn, int H,
                         const Mask& mask, cudaStream_t stream) {
  constexpr int L = D / (16 / sizeof(T)) < 32 ? D / (16 / sizeof(T)) : 32;  // lanes a row
  const size_t rows = static_cast<size_t>(Bn) * mask.Sq * H;
  const size_t blocks = (rows * L + NT - 1) / NT;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>(blocks), NT, 0, stream>>>(out, dout, delta, mask.Sq, H, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const float* part, T* dk, T* dv, int Bn, int KVH, int D, int splits,
                          const Mask& mask, cudaStream_t stream) {
  if (splits == 1) return cudaSuccess;
  const size_t n = static_cast<size_t>(Bn) * mask.Skv * KVH * D;
  const size_t blocks = (2 * n / 4 + NT - 1) / NT;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  bwd_reduce_kernel<T><<<static_cast<unsigned>(blocks), NT, 0, stream>>>(part, dk, dv, n,
                                                                         splits, mask.sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const float* q, const float* k, const float* v, const float* out,
                        const float* dout, const float* lse, float* delta, float* dq, float* dk,
                        float* dv, float* part, int Bn, int H, int KVH, int splits,
                        const Mask& mask, cudaStream_t stream) {
  constexpr int B = Tile<D>::B;
  const int nq = (mask.Sq + B - 1) / B, nk = (mask.Skv + B - 1) / B;
  if (nk > 65535) return cudaErrorInvalidValue;
  cudaError_t err = launch_delta<float, D>(out, dout, delta, Bn, H, mask, stream);
  if (err != cudaSuccess) return err;

  auto dkdv = bwd_dkdv_kernel<D>;
  const size_t smem_kv = smem_bytes<D>(2);
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(Bn * KVH * splits, nk), NT, smem_kv, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                                             part, H, KVH, splits, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_reduce<float>(part, dk, dv, Bn, KVH, D, splits, mask, stream);
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_kernel<D>;
  const size_t smem_q = smem_bytes<D>(1);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  dqk<<<dim3(nq, Bn * H), NT, smem_q, stream>>>(q, k, v, dout, lse, delta, dq, H, KVH, mask);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
                        const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                        bf16* dv, float* part, int Bn, int H, int KVH, int splits,
                        const Mask& mask, cudaStream_t stream) {
  using C = Mma<D>;
  const int nq = (mask.Sq + BQD - 1) / BQD, nk = (mask.Skv + C::BKV - 1) / C::BKV;
  if (nq > 65535 || nk > 65535) return cudaErrorInvalidValue;
  cudaError_t err = launch_delta<bf16, D>(out, dout, delta, Bn, H, mask, stream);
  if (err != cudaSuccess) return err;

  auto dkdv = bwd_dkdv_mma_kernel<D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::dkdv_smem));
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(Bn * KVH * splits, nk), C::NW * 32, C::dkdv_smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, part, H, KVH, splits, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_reduce<bf16>(part, dk, dv, Bn, KVH, D, splits, mask, stream);
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_mma_kernel<D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::dq_smem));
  if (err != cudaSuccess) return err;
  dqk<<<dim3(Bn * H, nq), BQD * 2, C::dq_smem, stream>>>(q, k, v, dout, lse, delta, dq, H, KVH,
                                                        mask);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, float* part, int Bn, int H, int KVH, int splits,
                     const Mask& mask, cudaStream_t st) {
  if (dtype == kFloat32)
    return launch_fp32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<const float*>(out),
                          static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
                          static_cast<float*>(dk), static_cast<float*>(dv), part, Bn, H, KVH,
                          splits, mask, st);
  if (dtype == kBFloat16) {
    if constexpr (D >= 32) {
      return launch_bf16<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<const bf16*>(out),
                            static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
                            static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, Bn, H, KVH,
                            splits, mask, st);
    }
  }
  return cudaErrorInvalidValue;  // bf16 at D = 16, or another dtype
}

}  // namespace

// Returns the CUDA error of the launches (0 on success); the wrapper raises on
// anything else. The caller checks shapes, dtypes, devices, alignment and
// contiguity, and allocates dq, dk, dv, the fp32 `delta` scratch (B, H, Sq)
// and, for `splits` > 1 (a divisor of H / KVH), the fp32 `scratch` of the
// head splits' partial dk and dv, (2, splits, B, Skv, KVH, D). Head dims are
// the forward kernel's: 32-256 in both dtypes, 16 in fp32.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, void* scratch, int dtype, int B, int Sq,
                                   int Skv, int H, int KVH, int D, int causal, int window,
                                   int q_offset, int splits, float sm_scale, float softcap,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH || splits < 1 || (H / KVH) % splits ||
      (splits > 1 && scratch == nullptr) || static_cast<long long>(B) * H > 65535)
    return cudaErrorInvalidValue;  // the fp32 dq grid's y; the launches check their key tiles
  const Mask mask{Sq, Skv, causal, window, q_offset, sm_scale, softcap};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* part = static_cast<float*>(scratch);
  switch (D) {
    case 16:  // the smoke configs' head dim: fp32 only, as the forward kernel
      if (dtype != kFloat32) return cudaErrorInvalidValue;
      return launch_d<16>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, part, B, H, KVH, splits,
                          mask, st);
    case 32:
      return launch_d<32>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, part, B, H, KVH, splits,
                          mask, st);
    case 64:
      return launch_d<64>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, part, B, H, KVH, splits,
                          mask, st);
    case 128:
      return launch_d<128>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, part, B, H, KVH,
                           splits, mask, st);
    case 256:
      return launch_d<256>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, part, B, H, KVH,
                           splits, mask, st);
    default:
      return cudaErrorInvalidValue;
  }
}
