// Rotary position embedding (half-split RoPE) of a layer's q and k, in one
// launch.
//
// Replaces no TPU kernel: the JAX package rotates q and k with jnp
// (src/repro/models/layers.py `apply_rope`), which XLA fuses. The port's plain
// version (models/layers.py `apply_rope` / `_rotate`) runs it as some 19
// PyTorch operations each for q and for k, in fp32 temporaries; this kernel
// does the same arithmetic in one pass.
//
// Layout: q (B, S, H, D) and k (B, S, KVH, D) with the last dim contiguous and
// any strides on the others (given in elements), positions (B, S) int32 or
// int64 with any strides, inv (D / 2,) fp32, the inverse frequencies the
// wrapper computes once with the plain version's own torch ops. The outputs
// q_out and k_out are contiguous, of q's and k's dtype (fp32 or bf16).
//
// What bounds it on the H100: the bytes. Each element of q and k is read once
// and written once (prefill of qwen2-7b's serving batch: 393 M elements a
// layer, 1.57 GB in bf16, 0.47 ms at 3.35 TB/s); the trigonometry is D / 2
// sines and cosines a token. The design:
//
// * A thread owns VEC pairs of one token: lanes [j0, j0 + VEC) of the first
//   half and the same of the second (VEC = 16 bytes of T, so each is one
//   16-byte load; 1 where a stride or an address is not 16-byte aligned), and
//   a chunk of the token's H + KVH heads. It computes its VEC angles and their
//   sines and cosines once, in registers, and rotates every head of its chunk
//   with them. The wrapper sizes the chunks so that the grid holds about one
//   wave of threads: at prefill one chunk of all heads (the angles computed
//   once a token and lane), at decode's 64 rows a head or two a thread, so
//   that the rows still spread over the card.
// * The numbers are the plain version's, to the bit: angle = float(pos) *
//   inv[j] rounded once, precise sinf / cosf (no fast math: the angles reach
//   1.3e5 rad at 131k positions), x1 * c - x2 * s and x2 * c + x1 * s with
//   each product and sum rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn:
//   no FMA contraction), then one rounding to T, to nearest even.
// * `inverse` rotates by -angle (s negated, which is exact): the transpose,
//   and so the gradient, with autograd's own roundings.

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads a block

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Args {
  const void* q;
  const void* k;
  void* q_out;
  void* k_out;
  const void* pos;
  const float* inv;
  long long q_sb, q_ss, q_sh;  // q's strides over (B, S, H), in elements
  long long k_sb, k_ss, k_sh;
  long long p_sb, p_ss;        // positions' strides over (B, S)
  long long rows;              // B * S
  int S, H, KVH, D;
  int lanes;                   // threads a token's head: D / 2 / VEC
  int chunk, chunks;           // heads a thread, chunks a token
  bool inverse;
};

template <typename T, int VEC, typename P>
__global__ void __launch_bounds__(NT) rope_kernel(const Args a) {
  using V = Pack<T, VEC>;
  const long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long per_row = static_cast<long long>(a.lanes) * a.chunks;
  if (t >= a.rows * per_row) return;
  const int g = static_cast<int>(t % a.lanes);
  const int c = static_cast<int>((t / a.lanes) % a.chunks);
  const long long row = t / per_row;
  const long long b = row / a.S, s = row % a.S;
  const int half = a.D / 2, j0 = g * VEC;

  const float p = static_cast<float>(static_cast<const P*>(a.pos)[b * a.p_sb + s * a.p_ss]);
  float cs[VEC], sn[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float ang = __fmul_rn(p, a.inv[j0 + i]);
    cs[i] = cosf(ang);
    sn[i] = a.inverse ? -sinf(ang) : sinf(ang);
  }

  const T* __restrict__ q = static_cast<const T*>(a.q) + b * a.q_sb + s * a.q_ss;
  const T* __restrict__ k = static_cast<const T*>(a.k) + b * a.k_sb + s * a.k_ss;
  T* __restrict__ q_out = static_cast<T*>(a.q_out) + row * a.H * a.D;
  T* __restrict__ k_out = static_cast<T*>(a.k_out) + row * a.KVH * a.D;
  const int h_end = min(a.H + a.KVH, (c + 1) * a.chunk);
#pragma unroll 4
  for (int h = c * a.chunk; h < h_end; ++h) {
    const bool is_q = h < a.H;
    const T* x = is_q ? q + h * a.q_sh : k + (h - a.H) * a.k_sh;
    T* y = is_q ? q_out + static_cast<long long>(h) * a.D
                : k_out + static_cast<long long>(h - a.H) * a.D;
    const V x1 = *reinterpret_cast<const V*>(x + j0);
    const V x2 = *reinterpret_cast<const V*>(x + half + j0);
    V y1, y2;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float a1 = to_f(x1.v[i]), a2 = to_f(x2.v[i]);
      y1.v[i] = from_f<T>(__fsub_rn(__fmul_rn(a1, cs[i]), __fmul_rn(a2, sn[i])));
      y2.v[i] = from_f<T>(__fadd_rn(__fmul_rn(a2, cs[i]), __fmul_rn(a1, sn[i])));
    }
    *reinterpret_cast<V*>(y + j0) = y1;
    *reinterpret_cast<V*>(y + half + j0) = y2;
  }
}

template <typename T, int VEC>
cudaError_t launch(const Args& a, bool pos64, cudaStream_t st) {
  const long long threads = a.rows * a.lanes * a.chunks;
  const unsigned blocks = static_cast<unsigned>((threads + NT - 1) / NT);
  if (pos64)
    rope_kernel<T, VEC, long long><<<blocks, NT, 0, st>>>(a);
  else
    rope_kernel<T, VEC, int><<<blocks, NT, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(const Args& a, int vec, bool pos64, cudaStream_t st) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) return launch<T, kWide>(a, pos64, st);
  if (vec == 1) return launch<T, 1>(a, pos64, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_out, k_out = RoPE(q, k) at `pos` (by -angle with `inverse`); see the top
// of this file for the layout. `vec` is 16 / sizeof(T) or 1, `chunk` the heads
// a thread rotates. Returns the launch's error code.
extern "C" int rope_fwd(const void* q, const void* k, void* q_out, void* k_out,
                        const void* pos, const void* inv, int dtype, int pos64, int vec,
                        int inverse, int B, int S, int H, int KVH, int D, int chunk,
                        long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                        long long k_ss, long long k_sh, long long p_sb, long long p_ss,
                        void* stream) {
  if (D % 2 || D / 2 % vec || chunk < 1) return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.q_out = q_out;
  a.k_out = k_out;
  a.pos = pos;
  a.inv = static_cast<const float*>(inv);
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.p_sb = p_sb;
  a.p_ss = p_ss;
  a.rows = static_cast<long long>(B) * S;
  a.S = S;
  a.H = H;
  a.KVH = KVH;
  a.D = D;
  a.lanes = D / 2 / vec;
  a.chunk = chunk;
  a.chunks = (H + KVH + chunk - 1) / chunk;
  a.inverse = inverse != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_vec<float>(a, vec, pos64 != 0, st);
  if (dtype == kBFloat16) return dispatch_vec<__nv_bfloat16>(a, vec, pos64 != 0, st);
  return cudaErrorInvalidValue;
}
