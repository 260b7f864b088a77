// Prefill attention for Hopper: causal / sliding-window / tanh-softcapped GQA
// attention with a q_offset, online softmax in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`). The TPU kernel walks the KV
// tiles as a sequential grid axis and carries (m, l, acc) in VMEM scratch;
// here one thread block owns one (q tile, batch x head) and loops over the KV
// tiles itself.
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, KVH, D), o (B, Sq, H, D), all
// contiguous and 16-byte aligned; query head h reads kv head h / (H / KVH),
// so repeated KV is never stored. fp32 or bf16 in, the same dtype out;
// scores, statistics and the accumulator are fp32. With a non-null `lse`
// (fp32, (B, H, Sq)) each row's log-sum-exp of its scaled, capped scores,
// natural log, is written too: the training forward saves it for
// csrc/flash_attention_bwd.cu; serving passes null.
//
// What bounds it on the H100: at llama3.2-1b's serving prefill (q (8,256,32,64),
// bf16, causal) the bytes, 21 MB or 6.3 us at 3.35 TB/s, against 2.2 GFLOP or
// 2.2 us at 989 TFLOP/s bf16. Two kernels:
//
// * bf16: tensor cores in the FlashAttention-2 form. Each warp owns 16 query
//   rows (4 warps, 64 rows a block; 8 warps measured slower on an H100) and
//   keeps its Q fragments in registers for the whole KV loop.
//   64-key K and V tiles stream through a double-buffered shared-memory ring
//   filled by cp.async (tile j+1 loads while tile j is multiplied; rows at or
//   past Skv are zero-filled). Rows are padded by 16 bytes so ldmatrix reads
//   no bank twice. Both products are mma.sync m16n8k16 bf16 with fp32
//   accumulation; scale, softcap, mask and the online softmax run on the score
//   fragments in registers (in log2 units, one ex2 an element), with quad
//   shuffles for the row max, and P goes to the P.V product as bf16 fragments
//   straight from registers. Rounding P to bf16 is a rounding the plain
//   version does not make (the row sum l is taken before it). A tile that all
//   of a warp's rows see whole skips the mask. The grid puts the q tiles on
//   its slow axis in reverse, so the heaviest causal tiles start first. At
//   D <= 64 ptxas is held to 4 blocks an SM, as many as the shared memory
//   takes: the loop waits on loads and on dependent mma chains, and 16 warps
//   an SM hide more of that than 12 with more registers. At D = 64 that
//   costs a 4-byte spill, which measured cheaper than the 3-block build.
//   At D = 256 (recurrentgemma's MQA) the 128 registers of the output
//   accumulator leave no room for Q's 64 registers of fragments, so Q is
//   read from shared memory at each k-step instead (one ldmatrix per 16
//   columns, amortized over the tile's 8 mma n-tiles); the shared memory,
//   (64 + 4 x 64) rows of 264 bf16, is 168,960 bytes, one block an SM.
//   wgmma and TMA are left out. At 256 tokens the bound is the bytes (6.3 us
//   against 2.2 us of FLOPs), so a warpgroup / TMA producer-consumer design
//   is queued for long prompts, where FLOPs dominate; PERF.md has how far this
//   kernel stands from one (cuDNN's) at the serving shape.
// * fp32: CUDA-core FMAs from shared memory (64x64 tiles, 256 threads, each
//   thread a 4x4 block of scores and a 4x(D/16) block of the output), kept
//   because TF32 tensor cores would not hold the fp32 tolerance. It also
//   takes D = 16, the head dim of the smoke configs (cfg.smoke()), which
//   the bf16 kernel does not. At D = 256 its tiles take 214,272 bytes of
//   shared memory, under the 232,448 a block may have.
//
// Both keep the reference's finite NEG_INF, its tile-skip rule (with this
// kernel's q tile) and the "fully masked first tile gets p = 1 and is wiped by
// alpha = 0" behaviour. A row that no key is visible to (its running max is
// still NEG_INF at the end) outputs zeros, as the Pallas kernel gives a row
// with no tile at all, and its lse is NEG_INF; the backward kernel gives it
// zero gradients. The reference's jnp paths average V there instead
// (ROADMAP C); no causal row of a train or serving step is such a row.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

template <int D>
constexpr size_t smem_floats() {
  // Q tile, K tile (rows padded by one float against bank conflicts),
  // V tile, score tile (padded), and the per-row m, l, alpha
  return BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int KVH, int causal,
    int window, int q_offset, float sm_scale, float softcap) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DC = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * D;
  float* Vs = Ks + BK * DP;
  float* Ss = Vs + BK * D;
  float* m_s = Ss + BQ * SP;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KVH) * D;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;
  T* ob = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    Qs[i] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * q_row + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // thread tile: rows ty*4 .. ty*4+3; columns tx + 16*c
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  const int first_q = q_offset + q0;
  const int nk = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    // skip tiles wholly outside the causal / window support, as the TPU
    // kernel does (the test depends on block indices only, so the whole
    // block skips together and the barriers below stay uniform)
    if (causal) {
      bool needed = k0 <= first_q + BQ - 1;
      if (window > 0) needed = needed && (k0 + BK - 1 > first_q - window);
      if (!needed) continue;
    }
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i % D;
      const bool in = k0 + j < Skv;
      // rows past Skv are zero: a zero-weight garbage V row would still
      // poison the product
      Ks[j * DP + d] = in ? to_f(kb[(k0 + j) * kv_row + d]) : 0.f;
      Vs[j * D + d] = in ? to_f(vb[(k0 + j) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // scores S = Q K^T * scale, softcapped and masked
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * D + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const int qp = first_q + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const int kp = k0 + col;
        float x = s[r][c] * sm_scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        Ss[row * SP + col] = ok ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 columns each
    {
      const int row = tid / 4, part = tid % 4;
      float* srow = Ss + row * SP + part * 16;
      const float m_prev = m_s[row];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_prev - m_new);
      __syncwarp();
      if (part == 0) {
        m_s[row] = m_new;
        l_s[row] = alpha * l_s[row] + sum;
        a_s[row] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = a_s[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ss[(ty * 4 + r) * SP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (q0 + row >= Sq) continue;
    // a row no key was visible to outputs zeros (with no tile at all, l == 0)
    const bool seen = m_s[row] != kNegInf;
    const float l = l_s[row];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[(q0 + row) * q_row + tx + 16 * c] = from_f<T>(seen ? acc[r][c] / l : 0.f);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + q0 + row] =
          seen ? m_s[row] + logf(l) : kNegInf;
  }
}

template <int D>
cudaError_t launch_fp32(const float* q, const float* k, const float* v, float* o, float* lse,
                        int B, int Sq, int Skv, int H, int KVH, int causal, int window,
                        int q_offset, float sm_scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<float, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(q, k, v, o, lse, Sq, Skv, H, KVH, causal, window,
                                     q_offset, sm_scale, softcap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async double-buffered K/V ring

constexpr int MMA_WARPS = 4;  // warps per block; each owns 16 query rows

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x; -inf and very negative x give 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NW, int D>
constexpr size_t mma_smem_bytes() {
  // Q tile and two stages each of K and V, rows padded by 8 elements (16 B)
  return static_cast<size_t>(NW * 16 + 4 * BK) * (D + 8) * sizeof(bf16);
}

// blocks per SM that ptxas must fit in registers: at D <= 64 as many as the
// shared memory allows (16 warps: 4 blocks of 4), otherwise no bound
template <int NW, int D>
struct Occupancy {
  static constexpr int kMinBlocks = D <= 64 ? 16 / NW : 1;
};

template <int NW, int D>
__global__ void __launch_bounds__(NW * 32, (Occupancy<NW, D>::kMinBlocks))
    flash_fwd_bf16_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int KVH, int causal,
    int window, int q_offset, float sm_scale, float softcap) {
  static_assert(D % 16 == 0 && BK % 16 == 0, "mma tiles are 16 deep");
  constexpr int BQM = NW * 16;  // query rows per block
  constexpr int NTM = NW * 32;
  constexpr int LD = D + 8;     // shared-memory row stride, elements
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int KD = D / 16;    // k-steps of Q K^T
  constexpr int NS = BK / 8;    // score n-tiles (8 keys each) per warp
  constexpr int ND = D / 8;     // output n-tiles (8 columns each) per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQM * LD;     // stages 0 and 1
  bf16* Vs = Ks + 2 * BK * LD;  // stages 0 and 1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row and column pair
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQM;  // heaviest causal tiles first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KVH) * D;
  const bf16* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
  const bf16* kb = k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(kvh) * D;
  bf16* ob = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;

  // the KV tiles this q tile needs: all of them, or under a causal mask the
  // reference's tile-skip rule with this kernel's q tile (an interval, since
  // the first condition only fails past it and the second only before it)
  const int first_q = q_offset + q0;
  const int nk = (Skv + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nk - 1;
  if (causal) {
    kt_lo = nk;
    kt_hi = -1;
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * BK;
      bool needed = k0 <= first_q + BQM - 1;
      if (window > 0) needed = needed && (k0 + BK - 1 > first_q - window);
      if (needed) {
        kt_lo = min(kt_lo, kt);
        kt_hi = kt;
      }
    }
  }

  auto load_kv = [&](int kt, int stage) {
    bf16* kd = Ks + stage * BK * LD;
    bf16* vd = Vs + stage * BK * LD;
    for (int i = tid; i < BK * CH; i += NTM) {
      const int r = i / CH, c = i % CH;
      const int key = kt * BK + r;
      const bool in = key < Skv;  // rows past Skv are zero: 0 x garbage V is not 0
      const size_t off = in ? static_cast<size_t>(key) * kv_row + c * 8 : 0;
      cp_async_16(kd + r * LD + c * 8, kb + off, in);
      cp_async_16(vd + r * LD + c * 8, vb + off, in);
    }
  };

  float m_r[2] = {kNegInf, kNegInf};  // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // Q's fragments stay in registers up to D = 128; at D = 256 the output
  // accumulator alone takes 128 registers a thread, so each k-step reloads
  // its Q fragment from the Q tile, which stays in shared memory
  constexpr bool kQInRegs = D <= 128;
  uint32_t qf[kQInRegs ? KD : 1][4];
  const bf16* q_frag = Qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;

  if (kt_lo <= kt_hi) {
    for (int i = tid; i < BQM * CH; i += NTM) {
      const int r = i / CH, c = i % CH;
      const bool in = q0 + r < Sq;
      cp_async_16(Qs + r * LD + c * 8, qb + (in ? (q0 + r) * q_row + c * 8 : 0), in);
    }
    load_kv(kt_lo, 0);
    cp_async_commit();
  }

  const int wq = first_q + warp * 16;  // the warp's first query position
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi) {
      load_kv(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and on the first pass Q) is in shared memory

    if (kQInRegs && kt == kt_lo) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kQInRegs ? kk : 0], q_frag + kk * 16);
    }
    const bf16* Kt = Ks + stage * BK * LD;
    const bf16* Vt = Vs + stage * BK * LD;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int qi = kQInRegs ? kk : 0;
      if (!kQInRegs) ldmatrix_x4(qf[0], q_frag + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (jp * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[2 * jp], qf[qi], kf[0], kf[1]);
        mma_bf16_16816(s[2 * jp + 1], qf[qi], kf[2], kf[3]);
      }
    }

    // scale, softcap and mask in registers, scores in log2 units (x log2 e,
    // so that exp is one ex2); a masked score is NEG_INF in these units too,
    // which keeps the reference's semantics: ex2(NEG_INF - NEG_INF) = 1 and
    // ex2(NEG_INF - real) = 0. Element e of n-tile j is row g + 8 * (e / 2),
    // key 8 * j + 2 * t + e % 2. A tile that every row of the warp sees whole
    // skips the mask.
    const int k_last = kt * BK + BK - 1;
    const bool whole = k_last < Skv && (!causal || k_last <= wq) &&
                       (window <= 0 || kt * BK > wq + 15 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if (softcap > 0.f)
          x = tanhf(s[j][e] * (sm_scale / softcap)) * (softcap * kLog2e);
        else
          x = s[j][e] * (sm_scale * kLog2e);
        if (!whole) {
          const int qp = wq + g + 8 * (e / 2);
          const int kp = kt * BK + 8 * j + 2 * t + e % 2;
          bool ok = kp < Skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    // online softmax: the four lanes of a quad share a row
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = ex2(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - m_r[e / 2]);
        s[j][e] = p;
        l_r[e / 2] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: the score fragments of two n-tiles are the A fragment of
    // one 16-key step, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16_16816(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // out = acc / l, zeros for a row no key was visible to (with no tile at
  // all, l == 0), staged through this warp's own Q rows so that the stores to
  // device memory are 16 bytes a lane; lse = m ln 2 + ln l (m in log2 units)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const bool seen = m_r[r] != kNegInf;
    inv[r] = seen ? 1.f / l : 0.f;
    const int row = q0 + warp * 16 + g + 8 * r;
    if (lse != nullptr && t == 0 && row < Sq)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = seen ? m_r[r] * kLn2 + logf(l) : kNegInf;
  }
  bf16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Os + g * LD + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * LD + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const int row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(ob + row * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
  }
}

template <int D>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
                        int Sq, int Skv, int H, int KVH, int causal, int window, int q_offset,
                        float sm_scale, float softcap, cudaStream_t stream) {
  constexpr int NW = MMA_WARPS;
  const int nq = (Sq + NW * 16 - 1) / (NW * 16);
  if (nq > 65535) return cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes<NW, D>();
  auto kernel = flash_fwd_bf16_mma_kernel<NW, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, nq);
  kernel<<<grid, NW * 32, smem, stream>>>(q, k, v, o, lse, Sq, Skv, H, KVH, causal, window,
                                          q_offset, sm_scale, softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                     int B, int Sq, int Skv, int H, int KVH, int causal, int window,
                     int q_offset, float sm_scale, float softcap, cudaStream_t stream) {
  if (dtype == kFloat32)
    return launch_fp32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<float*>(o), lse, B, Sq,
                          Skv, H, KVH, causal, window, q_offset, sm_scale, softcap, stream);
  if (dtype == kBFloat16)
    return launch_bf16<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, B, Sq, Skv,
                          H, KVH, causal, window, q_offset, sm_scale, softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); the wrapper raises on
// anything else. The caller checks shapes, dtypes, devices, alignment and
// contiguity. bf16 runs the tensor-core kernel, fp32 the CUDA-core one.
// `lse` may be null (serving): then it is not written.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse_out, int dtype, int B, int Sq, int Skv, int H,
                                   int KVH, int D, int causal, int window, int q_offset,
                                   float sm_scale, float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 16:  // the smoke configs' head dim: fp32 only (the mma path wants D >= 32)
      if (dtype != kFloat32) return cudaErrorInvalidValue;
      return launch_fp32<16>(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<float*>(o), lse, B, Sq,
                             Skv, H, KVH, causal, window, q_offset, sm_scale, softcap, st);
    case 32:
      return launch_d<32>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KVH, causal, window, q_offset,
                          sm_scale, softcap, st);
    case 64:
      return launch_d<64>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KVH, causal, window, q_offset,
                          sm_scale, softcap, st);
    case 128:
      return launch_d<128>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KVH, causal, window, q_offset,
                           sm_scale, softcap, st);
    case 256:
      return launch_d<256>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KVH, causal, window, q_offset,
                           sm_scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}
