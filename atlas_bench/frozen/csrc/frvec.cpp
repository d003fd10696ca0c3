// Native BN254 Fr vector kernels: 4x64-bit Montgomery arithmetic (CIOS),
// OpenMP-parallel elementwise ops over contiguous (n,4) u64 LE arrays.
//
// This is the host-side scalar-field performance layer backing the sumcheck
// protocol loops (reference: arkworks ark_bn254::Fr used throughout
// joltworks/src/subprotocols/sumcheck.rs) — the Python side keeps vectors in
// Montgomery limb form end-to-end and only converts at Fr boundaries.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -o libfrvec.so frvec.cpp

#include <cstdint>
#include <cstring>
#include <vector>
#include <omp.h>
#include <cstdlib>

#include "mont4.h"
#include "mont52.h"

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef int64_t i64;

struct Fr4 { u64 v[4]; };

static const Fr4 R_MOD = {{0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
static const u64 R_INV = 0xc2e1f593efffffffULL;  // -r^{-1} mod 2^64
static const Fr4 R1 = {{0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
                        0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL}};
static const Fr4 R2 = {{0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                        0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL}};

static inline bool ge(const Fr4&a, const Fr4&b){
  for(int i=3;i>=0;i--){ if(a.v[i]!=b.v[i]) return a.v[i]>b.v[i]; }
  return true;
}

static inline void sub_nocheck(Fr4&o, const Fr4&a, const Fr4&b){
  u128 borrow=0;
  for(int i=0;i<4;i++){
    u128 d=(u128)a.v[i]-b.v[i]-borrow;
    o.v[i]=(u64)d; borrow=(d>>64)&1;
  }
}

static inline void fr_add(Fr4&o, const Fr4&a, const Fr4&b){
  u128 carry=0;
  for(int i=0;i<4;i++){
    u128 s=(u128)a.v[i]+b.v[i]+carry;
    o.v[i]=(u64)s; carry=s>>64;
  }
  if(carry || ge(o,R_MOD)) sub_nocheck(o,o,R_MOD);
}

static inline void fr_sub(Fr4&o, const Fr4&a, const Fr4&b){
  u128 borrow=0;
  Fr4 t;
  for(int i=0;i<4;i++){
    u128 d=(u128)a.v[i]-b.v[i]-borrow;
    t.v[i]=(u64)d; borrow=(d>>64)&1;
  }
  if(borrow){
    u128 carry=0;
    for(int i=0;i<4;i++){
      u128 s=(u128)t.v[i]+R_MOD.v[i]+carry;
      t.v[i]=(u64)s; carry=s>>64;
    }
  }
  o=t;
}

// CIOS Montgomery multiplication
#ifdef MONT4_ADX
static const u64 FR_QC[5] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                             0xb85045b68181585dULL, 0x30644e72e131a029ULL,
                             0xc2e1f593efffffffULL};
static inline void fr_mul(Fr4&out, const Fr4&a, const Fr4&b){
  mont4_mul_adx(out.v, a.v, b.v, FR_QC);
}
#else
static inline void fr_mul(Fr4&out, const Fr4&a, const Fr4&b){
  u64 t[6]={0,0,0,0,0,0};
  for(int i=0;i<4;i++){
    u128 carry=0;
    u64 ai=a.v[i];
    for(int j=0;j<4;j++){
      u128 cur=(u128)t[j]+(u128)ai*b.v[j]+carry;
      t[j]=(u64)cur; carry=cur>>64;
    }
    u128 s=(u128)t[4]+carry;
    t[4]=(u64)s; t[5]=(u64)(s>>64);
    u64 m=t[0]*R_INV;
    u128 cur=(u128)t[0]+(u128)m*R_MOD.v[0];
    carry=cur>>64;
    for(int j=1;j<4;j++){
      cur=(u128)t[j]+(u128)m*R_MOD.v[j]+carry;
      t[j-1]=(u64)cur; carry=cur>>64;
    }
    s=(u128)t[4]+carry;
    t[3]=(u64)s;
    t[4]=t[5]+(u64)(s>>64);
    t[5]=0;
  }
  Fr4 r={{t[0],t[1],t[2],t[3]}};
  if(t[4] || ge(r,R_MOD)) sub_nocheck(r,r,R_MOD);
  out=r;
}
#endif  // MONT4_ADX

#define PAR_THRESH 2048

extern "C" {

// ---- conversions -----------------------------------------------------------

// signed 64-bit ints -> Montgomery form (fold negatives mod r)
void frv_from_i64(const i64* in, u64* out, i64 n){
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    i64 v=in[i];
    Fr4 c={{0,0,0,0}};
    if(v>=0){ c.v[0]=(u64)v; }
    else {
      // r - |v|: |v| <= 2^63 < r0? r0=0x43E1..>2^62 but |v| can reach 2^63.
      u64 mag=(u64)(-(u128)v);
      if(mag<=R_MOD.v[0]){ c=R_MOD; c.v[0]-=mag; }
      else { Fr4 m={{mag,0,0,0}}; sub_nocheck(c,R_MOD,m); }
    }
    Fr4 o; fr_mul(o,c,R2);
    memcpy(out+i*4,o.v,32);
  }
}

// canonical 4-limb -> Montgomery
void frv_encode(const u64* in, u64* out, i64 n){
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    Fr4 c; memcpy(c.v,in+i*4,32);
    Fr4 o; fr_mul(o,c,R2);
    memcpy(out+i*4,o.v,32);
  }
}

// Montgomery -> canonical 4-limb
void frv_decode(const u64* in, u64* out, i64 n){
  static const Fr4 ONE={{1,0,0,0}};
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    Fr4 c; memcpy(c.v,in+i*4,32);
    Fr4 o; fr_mul(o,c,ONE);
    memcpy(out+i*4,o.v,32);
  }
}

// ---- elementwise -----------------------------------------------------------

void frv_mul(const u64* a, const u64* b, u64* out, i64 n){
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    Fr4 x,y,o;
    memcpy(x.v,a+i*4,32); memcpy(y.v,b+i*4,32);
    fr_mul(o,x,y);
    memcpy(out+i*4,o.v,32);
  }
}

void frv_add(const u64* a, const u64* b, u64* out, i64 n){
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    Fr4 x,y,o;
    memcpy(x.v,a+i*4,32); memcpy(y.v,b+i*4,32);
    fr_add(o,x,y);
    memcpy(out+i*4,o.v,32);
  }
}

void frv_sub(const u64* a, const u64* b, u64* out, i64 n){
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    Fr4 x,y,o;
    memcpy(x.v,a+i*4,32); memcpy(y.v,b+i*4,32);
    fr_sub(o,x,y);
    memcpy(out+i*4,o.v,32);
  }
}

// out = a * s (s a single Montgomery scalar)
void frv_scale(const u64* a, const u64* s, u64* out, i64 n){
  Fr4 sc; memcpy(sc.v,s,32);
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    Fr4 x,o;
    memcpy(x.v,a+i*4,32);
    fr_mul(o,x,sc);
    memcpy(out+i*4,o.v,32);
  }
}

// out = a + s * b (axpy; the sumcheck bind primitive's general form)
void frv_axpy(const u64* a, const u64* s, const u64* b, u64* out, i64 n){
  Fr4 sc; memcpy(sc.v,s,32);
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    Fr4 x,y,o;
    memcpy(x.v,a+i*4,32); memcpy(y.v,b+i*4,32);
    fr_mul(o,y,sc);
    fr_add(o,x,o);
    memcpy(out+i*4,o.v,32);
  }
}

// Parallel zero fill (u64 words). numpy's calloc reuses dirty arena pages
// for large short-lived buffers, so np.zeros degrades to a serial memset;
// this spreads the page-touch across cores.
void frv_zero(u64* out, i64 nwords){
  #pragma omp parallel
  {
    int nt=omp_get_num_threads(), t=omp_get_thread_num();
    i64 lo=nwords*(i64)t/nt, hi=nwords*(i64)(t+1)/nt;
    if(hi>lo) memset(out+lo, 0, (size_t)(hi-lo)*8);
  }
}

// ---- reductions ------------------------------------------------------------

void frv_sum(const u64* a, i64 n, u64* out){
  int nt=1;
  #ifdef _OPENMP
  #endif
  Fr4 total={{0,0,0,0}};
  #pragma omp parallel if(n>PAR_THRESH)
  {
    Fr4 local={{0,0,0,0}};
    #pragma omp for schedule(static) nowait
    for(i64 i=0;i<n;i++){
      Fr4 x; memcpy(x.v,a+i*4,32);
      fr_add(local,local,x);
    }
    #pragma omp critical
    fr_add(total,total,local);
  }
  (void)nt;
  memcpy(out,total.v,32);
}

void frv_dot(const u64* a, const u64* b, i64 n, u64* out){
  Fr4 total={{0,0,0,0}};
  #pragma omp parallel if(n>PAR_THRESH)
  {
    Fr4 local={{0,0,0,0}};
    #pragma omp for schedule(static) nowait
    for(i64 i=0;i<n;i++){
      Fr4 x,y,p;
      memcpy(x.v,a+i*4,32); memcpy(y.v,b+i*4,32);
      fr_mul(p,x,y);
      fr_add(local,local,p);
    }
    #pragma omp critical
    fr_add(total,total,local);
  }
  memcpy(out,total.v,32);
}

// sum_i a[i]*b[i]*c[i] (degree-2 sumcheck round evaluation in one pass)
void frv_dot3(const u64* a, const u64* b, const u64* c, i64 n, u64* out){
  Fr4 total={{0,0,0,0}};
  #pragma omp parallel if(n>PAR_THRESH)
  {
    Fr4 local={{0,0,0,0}};
    #pragma omp for schedule(static) nowait
    for(i64 i=0;i<n;i++){
      Fr4 x,y,z,p;
      memcpy(x.v,a+i*4,32); memcpy(y.v,b+i*4,32); memcpy(z.v,c+i*4,32);
      fr_mul(p,x,y);
      fr_mul(p,p,z);
      fr_add(local,local,p);
    }
    #pragma omp critical
    fr_add(total,total,local);
  }
  memcpy(out,total.v,32);
}

// ---- sumcheck fused kernels ------------------------------------------------

// bind: out[i] = lo[i] + r*(hi[i]-lo[i]), lo/hi length n
static inline bool fr4_zero(const u64* p){
  return (p[0]|p[1]|p[2]|p[3])==0;
}

void frv_bind(const u64* lo, const u64* hi, const u64* r, u64* out, i64 n){
  Fr4 rc; memcpy(rc.v,r,32);
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    // zero-skip: one-hot rows stay mostly zero through the address rounds
    if(fr4_zero(lo+i*4) && fr4_zero(hi+i*4)){
      memset(out+i*4, 0, 32);
      continue;
    }
    Fr4 l,h,d,o;
    memcpy(l.v,lo+i*4,32); memcpy(h.v,hi+i*4,32);
    fr_sub(d,h,l);
    fr_mul(d,d,rc);
    fr_add(o,l,d);
    memcpy(out+i*4,o.v,32);
  }
}

// sumcheck eval ladder: for the univariate restriction P(t) over pairs
// (lo, hi), emit [P(0), P(2), P(3), ..., P(d)] = [lo, lo+2diff, +diff, ...]
// outs: (d) x n contiguous blocks, d = number of emitted evals
void frv_eval_ladder(const u64* lo, const u64* hi, i64 n, int nevals,
                     u64* outs){
  #pragma omp parallel for schedule(static) if(n>PAR_THRESH)
  for(i64 i=0;i<n;i++){
    Fr4 l,h,d;
    memcpy(l.v,lo+i*4,32); memcpy(h.v,hi+i*4,32);
    fr_sub(d,h,l);
    memcpy(outs+i*4,l.v,32);           // P(0) = lo
    Fr4 cur=h;                          // P(1) = hi
    for(int t=1;t<nevals;t++){
      fr_add(cur,cur,d);               // P(t+1) = P(t) + diff
      memcpy(outs+(i64)t*n*4+i*4,cur.v,32);
    }
  }
}

// out[idx[j]] += vals[j]  (cycle->address accumulation, compute_G)
void frv_scatter_add(const u64* vals, const i64* idx, i64 T, u64* out,
                     i64 K){
  (void)K;
  for(i64 j=0;j<T;j++){
    Fr4 v,o;
    memcpy(v.v,vals+j*4,32);
    memcpy(o.v,out+idx[j]*4,32);
    fr_add(o,o,v);
    memcpy(out+idx[j]*4,o.v,32);
  }
}

// Batched one-hot RLC accumulation (opening-reduction prepare): member j
// adds the CONSTANT gammas[j] at every position idx[offs[j]..offs[j+1]).
// Threads own disjoint slices of the output index space and each scan the
// whole idx stream — collision-free without atomics, and no T-length value
// array is ever materialized (the old path built an FrArray.full per
// member and ran a serial scatter: ~3.3 s/prove at bench scale).
// init != 0: zero-fill each thread's range partition before scattering
// (fuses the accumulator memset into the same parallel pass — callers
// with one-hot-only groups otherwise paid a serial np.zeros page-memset).
void frv_scatter_const_ranges(const u64* gammas, const i64* offs,
                              i64 nmemb, const i64* idx, u64* out, i64 K,
                              int init){
  #pragma omp parallel
  {
    int nt=omp_get_num_threads(), t=omp_get_thread_num();
    i64 lo=K*(i64)t/nt, hi=K*(i64)(t+1)/nt;
    if(init && hi>lo) memset(out+lo*4, 0, (size_t)(hi-lo)*32);
    for(i64 j=0;j<nmemb;j++){
      Fr4 g; memcpy(g.v,gammas+j*4,32);
      for(i64 k=offs[j];k<offs[j+1];k++){
        i64 p=idx[k];
        if(p<lo||p>=hi) continue;
        Fr4 o; memcpy(o.v,out+p*4,32);
        fr_add(o,o,g);
        memcpy(out+p*4,o.v,32);
      }
    }
  }
}

// synthetic division by (X - u): quotient q of f(X)-f(u) in REVERSED order
// (qrev[j] = q[n-2-j]) so the store stream runs ascending — the natural
// descending store pattern defeated the write-combining/prefetch hardware
// (~50x slowdown past L2); the caller flips with one vectorized pass.
// Recurrence: q[n-2] = c[n-1]; q[i-1] = c[i] + u*q[i] for i = n-2 .. 1.
void frv_syndiv_rev(const u64* coeffs, const u64* u, i64 n, u64* qrev){
  Fr4 uu; memcpy(uu.v,u,32);
  Fr4 acc; memcpy(acc.v,coeffs+(n-1)*4,32);
  memcpy(qrev,acc.v,32);
  i64 w=1;
  for(i64 i=n-2;i>=1;i--,w++){
    Fr4 c; memcpy(c.v,coeffs+i*4,32);
    fr_mul(acc,acc,uu);
    fr_add(acc,acc,c);
    memcpy(qrev+w*4,acc.v,32);
  }
}

// back-compat in-order variant
void frv_syndiv(const u64* coeffs, const u64* u, i64 n, u64* q){
  frv_syndiv_rev(coeffs,u,n,q);
  // reverse in place
  for(i64 a=0,b=n-2;a<b;a++,b--){
    Fr4 t1,t2;
    memcpy(t1.v,q+a*4,32); memcpy(t2.v,q+b*4,32);
    memcpy(q+a*4,t2.v,32); memcpy(q+b*4,t1.v,32);
  }
}

// Horner evaluation sum c[i] u^i
void frv_horner(const u64* coeffs, const u64* u, i64 n, u64* out){
  Fr4 uu; memcpy(uu.v,u,32);
  Fr4 acc={{0,0,0,0}};
  for(i64 i=n-1;i>=0;i--){
    Fr4 c; memcpy(c.v,coeffs+i*4,32);
    fr_mul(acc,acc,uu);
    fr_add(acc,acc,c);
  }
  memcpy(out,acc.v,32);
}

// out[k] = sum_e m[k*E+e] * x[e]  (m: signed ints, x: Montgomery) — binds an
// integer dictionary against an eq table (GatherLarge / einsum operands)
void frv_i64_mat_vec(const i64* m, const u64* x, i64 V, i64 E, u64* out){
  #pragma omp parallel for schedule(static)
  for(i64 k=0;k<V;k++){
    Fr4 acc={{0,0,0,0}};
    for(i64 e=0;e<E;e++){
      i64 v=m[k*E+e];
      if(!v) continue;
      u64 mag = v<0 ? (u64)(-(u128)v) : (u64)v;
      Fr4 c={{mag,0,0,0}};
      Fr4 enc; fr_mul(enc,c,R2);
      Fr4 xe; memcpy(xe.v,x+e*4,32);
      Fr4 p; fr_mul(p,xe,enc);
      if(v<0) fr_sub(acc,acc,p); else fr_add(acc,acc,p);
    }
    memcpy(out+k*4,acc.v,32);
  }
}

int frv52_available();  // defined in the engine section below

static int use_ifma(){
  static int v = -1;
  if(v < 0) v = frv52_available() && !getenv("JOLT_ATLAS_NO_IFMA");
  return v;
}

#ifdef MONT52_AVAILABLE
static const mont52::Interop& fr52_io(){
  static mont52::Interop io = [](){
    mont52::Interop v;
    mont52::split52(R_MOD.v, v.ctx.p52);
    u64 inv = 1;
    for(int i=0;i<6;i++) inv *= 2 - R_MOD.v[0]*inv;
    v.ctx.n0inv52 = (u64)(0 - inv) & ((1ULL<<52)-1);
    return v;
  }();
  return io;
}

// 8-way body of the single-row fleet instance: bind the shared challenge
// and accumulate the block-grouped weighted q(0) sums. Field arithmetic
// is exact, so the result matches the scalar body bit for bit.
static void gruen1_ifma(const u64* row, u64* orow, i64 n, bool bind,
                        const u64* cc_prev,
                        const u64* whi, i64 whi_n, int shift,
                        const u64* wlo, int log_wlo, u64* out_q0){
  using namespace mont52;
  const Interop& io = fr52_io();
  const Ctx& C = io.ctx;
  const i64 half = bind ? n/4 : n/2;
  const i64 nb = n/2;
  const bool hl = whi_n > 1, ll = log_wlo >= 0;
  const i64 lomask = ll ? (((i64)1 << log_wlo) - 1) : 0;
  const i64 BS = hl ? ((i64)1 << shift) : half;
  const i64 nblk = BS ? (half + BS - 1) / BS : 0;
  // mont(16) = 16 * 2^256 mod p: pre-scales exactly ONE operand of each
  // mul8 so the 2^-260 reduction lands back in the 2^256 domain
  Fr4 mont16 = R1;
  for(int i=0;i<4;i++) fr_add(mont16, mont16, mont16);
  V5 ccv;
  {
    Fr4 cc16; Fr4 ccf; memcpy(ccf.v, cc_prev, 32);
    fr_mul(cc16, ccf, mont16);
    alignas(64) u64 cols[5][8];
    u64 t[5];
    split52(cc16.v, t);
    for(int j=0;j<5;j++)
      for(int k=0;k<8;k++) cols[j][k]=t[j];
    for(int j=0;j<5;j++)
      ccv.l[j] = _mm512_load_si512((const void*)cols[j]);
  }
  // pre-scale the wlo table by mont(16) once (it multiplies the bound
  // row inside the block loop)
  std::vector<u64> wlo16;
  const u64* wlo_s = wlo;
  if(ll){
    i64 wn = (i64)1 << log_wlo;
    wlo16.resize((size_t)wn*4);
    for(i64 i=0;i<wn;i++){
      Fr4 w; memcpy(w.v, wlo+i*4, 32);
      Fr4 o; fr_mul(o, w, mont16);
      memcpy(wlo16.data()+i*4, o.v, 32);
    }
    wlo_s = wlo16.data();
  }
  Fr4 total{{0,0,0,0}};
  alignas(64) u64 lanebuf[8*4];
  for(i64 b=0;b<nblk;b++){
    i64 j0=b*BS, j1 = j0+BS < half ? j0+BS : half;
    // 8-lane block accumulator, kept < 2p every iteration (one lazy
    // add + conditional 2p-subtract per step) so limbs stay below the
    // 2^52 bound vpmadd52 silently truncates at
    V5 acc; for(int j=0;j<5;j++) acc.l[j]=_mm512_setzero_si512();
    for(i64 j=j0;j<j1;j+=8){
      V5 lo;
      if(bind){
        V5 a2 = to52_8(io, row + j*4);
        V5 b2 = to52_8(io, row + (j+nb)*4);
        V5 d = sub8(C, b2, a2);
        lo = reduce_full(C, add8(mul8(C, d, ccv), a2));
        from52_8(io, lo, orow + j*4);
        a2 = to52_8(io, row + (j+half)*4);
        b2 = to52_8(io, row + (j+half+nb)*4);
        d = sub8(C, b2, a2);
        V5 hi = reduce_full(C, add8(mul8(C, d, ccv), a2));
        from52_8(io, hi, orow + (j+half)*4);
      } else {
        lo = to52_8(io, row + j*4);
      }
      if(ll){
        // consecutive wlo entries (j block-aligned, log_wlo >= 3
        // guaranteed by the caller's guard); table pre-scaled by mont16
        V5 w = to52_8(io, wlo_s + (j & lomask)*4);
        lo = mul8(C, lo, w);
      }
      acc = cond_sub(C, add8(acc, lo), 1);
    }
    // horizontal: convert lanes out (< 2p in, reduced < p out) and sum
    from52_8(io, acc, lanebuf);
    Fr4 bs{{0,0,0,0}};
    for(int k=0;k<8;k++){
      Fr4 v; memcpy(v.v, lanebuf + 4*k, 32);
      fr_add(bs, bs, v);
    }
    if(hl){
      Fr4 h; memcpy(h.v, whi+((j0>>shift)&(whi_n-1))*4, 32);
      fr_mul(bs, bs, h);
    }
    fr_add(total, total, bs);
  }
  memcpy(out_q0, total.v, 32);
}
#endif  // MONT52_AVAILABLE

#ifdef MONT52_AVAILABLE
// 8-way general Gruen round body (optionally fused with the previous
// challenge's bind): P row ladders, CSE aux products, weighted term sums.
// Domain bookkeeping: every mul8 divides by an extra 2^4, so each term's
// coefficient is pre-scaled by mont(16)^(expanded factor count) and the
// weight tables by mont(16) — the emitted totals land back in the plain
// 2^256 Montgomery domain and match the scalar kernels bit for bit.
static void gruen_round_ifma(const bool BIND,
                             const u64* const* rows, i64 P, i64 n,
                             const u64* c_prev, u64* const* out_rows,
                             int nevals, const u64* coeffs,
                             const i64* offsets, const i64* fidx, i64 T,
                             const i64* aux_offsets, const i64* aux_fidx,
                             i64 A, const u64* whi, i64 whi_n,
                             int whi_shift, const u64* wlo, int log_wlo,
                             u64* out){
  using namespace mont52;
  const Interop& io = fr52_io();
  const Ctx& C = io.ctx;
  const i64 nb = n/2, half = BIND ? n/4 : n/2;
  const i64 lomask = log_wlo >= 0 ? (((i64)1 << log_wlo) - 1) : 0;
  const bool hl = whi_n > 1, ll = log_wlo >= 0;
  const int MAXE=20, MAXP=96, MAXA=16;

  Fr4 mont16 = R1;
  for(int i=0;i<4;i++) fr_add(mont16, mont16, mont16);

  // expanded factor count per term / aux -> coefficient prescale 16^k
  // (a product tree with F expanded leaves plus its coefficient performs
  // exactly F mul8 calls)
  std::vector<i64> aux_cnt((size_t)A);
  for(i64 a=0;a<A;a++) aux_cnt[a] = aux_offsets[a+1]-aux_offsets[a];
  std::vector<u64> coeffs16((size_t)T*4);
  for(i64 k=0;k<T;k++){
    i64 F = 0;
    for(i64 f=offsets[k];f<offsets[k+1];f++){
      i64 idx = fidx[f];
      F += (idx >= P) ? aux_cnt[idx-P] : 1;
    }
    Fr4 cf; memcpy(cf.v, coeffs+k*4, 32);
    for(i64 i=0;i<F;i++) fr_mul(cf, cf, mont16);
    memcpy(coeffs16.data()+k*4, cf.v, 32);
  }
  std::vector<u64> wlo16, whi16;
  const u64 *wlo_s = wlo, *whi_s = whi;
  if(ll){
    i64 wn = (i64)1 << log_wlo;
    wlo16.resize((size_t)wn*4);
    for(i64 i=0;i<wn;i++){
      Fr4 w; memcpy(w.v, wlo+i*4, 32);
      Fr4 o; fr_mul(o, w, mont16);
      memcpy(wlo16.data()+i*4, o.v, 32);
    }
    wlo_s = wlo16.data();
  }
  if(hl){
    whi16.resize((size_t)whi_n*4);
    for(i64 i=0;i<whi_n;i++){
      Fr4 w; memcpy(w.v, whi+i*4, 32);
      Fr4 o; fr_mul(o, w, mont16);
      memcpy(whi16.data()+i*4, o.v, 32);
    }
    whi_s = whi16.data();
  }
  V5 ccv;
  if(BIND){
    Fr4 cc16; Fr4 ccf; memcpy(ccf.v, c_prev, 32);
    fr_mul(cc16, ccf, mont16);
    alignas(64) u64 cols[5][8];
    u64 t[5];
    split52(cc16.v, t);
    for(int j=0;j<5;j++) for(int k=0;k<8;k++) cols[j][k]=t[j];
    for(int j=0;j<5;j++) ccv.l[j]=_mm512_load_si512((const void*)cols[j]);
  }

  Fr4 total[MAXE];
  for(int t=0;t<nevals;t++) total[t]=Fr4{{0,0,0,0}};
  #pragma omp parallel if(half*P>PAR_THRESH)
  {
    Fr4 fin[MAXE];
    for(int t=0;t<nevals;t++) fin[t]=Fr4{{0,0,0,0}};
    V5 local[MAXE];
    for(int t=0;t<nevals;t++)
      for(int j=0;j<5;j++) local[t].l[j]=_mm512_setzero_si512();
    V5 e[MAXP+MAXA][MAXE];
    alignas(64) u64 lanebuf[8*4];
    #pragma omp for schedule(static) nowait
    for(i64 j=0;j<half;j+=8){
      for(i64 p=0;p<P;p++){
        V5 lo, hi;
        if(BIND){
          V5 a2 = to52_8(io, rows[p] + j*4);
          V5 b2 = to52_8(io, rows[p] + (j+nb)*4);
          lo = reduce_full(C, add8(mul8(C, sub8(C, b2, a2), ccv), a2));
          from52_8(io, lo, out_rows[p] + j*4);
          a2 = to52_8(io, rows[p] + (j+half)*4);
          b2 = to52_8(io, rows[p] + (j+half+nb)*4);
          hi = reduce_full(C, add8(mul8(C, sub8(C, b2, a2), ccv), a2));
          from52_8(io, hi, out_rows[p] + (j+half)*4);
        } else {
          lo = to52_8(io, rows[p] + j*4);
          if(nevals > 1) hi = to52_8(io, rows[p] + (j+half)*4);
        }
        e[p][0] = lo;
        if(nevals > 1){
          // d reduced < p so ladder entries stay < p + 20p < 2^260/16
          V5 d = cond_sub(C, cond_sub(C, sub8(C, hi, lo), 1), 0);
          V5 cur = hi;
          for(int t=1;t<nevals;t++){
            cur = add8(cur, d);
            e[p][t] = cur;
          }
        }
      }
      for(i64 a=0;a<A;a++){
        for(int t=0;t<nevals;t++){
          V5 prod = e[aux_fidx[aux_offsets[a]]][t];
          for(i64 f=aux_offsets[a]+1;f<aux_offsets[a+1];f++)
            prod = mul8(C, prod, e[aux_fidx[f]][t]);
          e[P+a][t] = prod;
        }
      }
      // per-j-lane weights (scalar gather into SoA; whi factor applied
      // lane-wise because j>>shift differs within the group when
      // shift < 3 — prescaled tables keep the domain)
      V5 wv; bool have_w = false;
      {
        alignas(64) u64 cols[5][8];
        bool set = false;
        u64 acc_t[8][5];
        for(int k=0;k<8;k++){
          i64 jj = j + k;
          u64 cur[5]; bool curset = false;
          if(ll){
            split52(wlo_s + (jj & lomask)*4, cur);
            curset = true;
          }
          if(hl){
            u64 h[5];
            split52(whi_s + ((jj >> whi_shift)&(whi_n-1))*4, h);
            if(curset){
              // two table factors: combine scalar-side with the
              // UNSCALED whi (fr_mul of two 16-scaled rows would carry
              // 16^2; one 16 is exactly what the weight mul8 consumes)
              Fr4 a1, b1, o1;
              memcpy(a1.v, wlo_s + (jj & lomask)*4, 32);
              memcpy(b1.v, whi + ((jj >> whi_shift)&(whi_n-1))*4, 32);
              fr_mul(o1, a1, b1);
              split52(o1.v, cur);
            } else {
              for(int q=0;q<5;q++) cur[q] = h[q];
              curset = true;
            }
          }
          if(curset){ for(int q=0;q<5;q++) acc_t[k][q] = cur[q]; }
          set = set || curset;
        }
        if(set){
          for(int q=0;q<5;q++)
            for(int k=0;k<8;k++) cols[q][k] = acc_t[k][q];
          for(int q=0;q<5;q++)
            wv.l[q] = _mm512_load_si512((const void*)cols[q]);
          have_w = true;
        }
      }
      for(int t=0;t<nevals;t++){
        V5 inner;
        for(int q=0;q<5;q++) inner.l[q]=_mm512_setzero_si512();
        bool any = false;
        for(i64 k=0;k<T;k++){
          V5 prod;
          if(offsets[k+1]==offsets[k]){
            // constant term: prescale-free (no factor muls) — convert
            // the coefficient itself
            alignas(64) u64 cols[5][8];
            u64 tt[5];
            split52(coeffs + k*4, tt);
            for(int q=0;q<5;q++)
              for(int kk=0;kk<8;kk++) cols[q][kk]=tt[q];
            for(int q=0;q<5;q++)
              prod.l[q]=_mm512_load_si512((const void*)cols[q]);
            inner = cond_sub(C, add8(inner, prod), 1);
            any = true;
            continue;
          }
          prod = e[fidx[offsets[k]]][t];
          for(i64 f=offsets[k]+1;f<offsets[k+1];f++)
            prod = mul8(C, prod, e[fidx[f]][t]);
          // coefficient (prescaled 16^F) folds the whole tree back to
          // the 2^256 domain
          alignas(64) u64 cols[5][8];
          u64 tt[5];
          split52(coeffs16.data() + k*4, tt);
          for(int q=0;q<5;q++)
            for(int kk=0;kk<8;kk++) cols[q][kk]=tt[q];
          V5 cf;
          for(int q=0;q<5;q++)
            cf.l[q]=_mm512_load_si512((const void*)cols[q]);
          prod = mul8(C, prod, cf);
          inner = cond_sub(C, add8(inner, prod), 1);
          any = true;
        }
        if(!any) continue;
        if(have_w) inner = mul8(C, inner, wv);
        local[t] = cond_sub(C, add8(local[t], inner), 1);
      }
    }
    // horizontal: fold the 8 lanes of each eval into the scalar total
    for(int t=0;t<nevals;t++){
      from52_8(io, local[t], lanebuf);
      for(int k=0;k<8;k++){
        Fr4 v; memcpy(v.v, lanebuf+4*k, 32);
        fr_add(fin[t], fin[t], v);
      }
    }
    #pragma omp critical
    for(int t=0;t<nevals;t++) fr_add(total[t],total[t],fin[t]);
  }
  for(int t=0;t<nevals;t++) memcpy(out+t*4,total[t].v,32);
}
#endif  // MONT52_AVAILABLE

// ---- fused sumcheck instance kernels ---------------------------------------
//
// A sumcheck instance is P rows (eq table + named polynomials, all length n)
// plus T weighted product terms over row indices. One round message =
// one frv_terms_round call; one challenge binding = one frv_bind_rows call.
// This replaces hundreds of per-factor elementwise kernel launches per round
// (the reference gets the same effect from rayon fold loops in
// subprotocols/sumcheck.rs).

// rows: (P, n) of u64x4. coeffs: (T,4) Montgomery. offsets: (T+1) prefix
// index into fidx; fidx: flat factor row-indices. out: (nevals, 4) sums for
// the ladder [P(0), P(2), ..., P(d)] where nevals = max(1, d).
void frv_terms_round(const u64* rows, i64 P, i64 n, int nevals,
                     const u64* coeffs, const i64* offsets, const i64* fidx,
                     i64 T, u64* out){
  i64 half=n/2;
  const int MAXE=20, MAXP=96;  // degree/row caps (checked Python-side)
  Fr4 total[MAXE];
  for(int t=0;t<nevals;t++) total[t]=Fr4{{0,0,0,0}};
  #pragma omp parallel if(half*P>PAR_THRESH)
  {
    Fr4 local[MAXE];
    for(int t=0;t<nevals;t++) local[t]=Fr4{{0,0,0,0}};
    Fr4 e[MAXP][MAXE];
    #pragma omp for schedule(static) nowait
    for(i64 j=0;j<half;j++){
      for(i64 p=0;p<P;p++){
        Fr4 lo,hi,d;
        memcpy(lo.v,rows+(p*n+j)*4,32);
        memcpy(hi.v,rows+(p*n+half+j)*4,32);
        e[p][0]=lo;                      // P(0)
        if(nevals>1){
          fr_sub(d,hi,lo);
          Fr4 cur=hi;                    // P(1)
          for(int t=1;t<nevals;t++){
            fr_add(cur,cur,d);           // P(2), P(3), ...
            e[p][t]=cur;
          }
        }
      }
      for(int t=0;t<nevals;t++){
        for(i64 k=0;k<T;k++){
          Fr4 prod; memcpy(prod.v,coeffs+k*4,32);
          for(i64 f=offsets[k];f<offsets[k+1];f++)
            fr_mul(prod,prod,e[fidx[f]][t]);
          fr_add(local[t],local[t],prod);
        }
      }
    }
    #pragma omp critical
    for(int t=0;t<nevals;t++) fr_add(total[t],total[t],local[t]);
  }
  for(int t=0;t<nevals;t++) memcpy(out+t*4,total[t].v,32);
}

// Pointer-array variants: rows passed as P separate contiguous buffers, so
// instance construction never copies and binding halves in place.

// aux products: shared factor-prefix subproducts computed once per (j, t)
// (common-subexpression elimination for e.g. the satclamp overflow
// indicators, which appear in ~10 terms each). fidx entries >= P reference
// aux slot (idx - P); aux factor lists reference rows only.
void frv_terms_round_p(const u64* const* rows, i64 P, i64 n, int nevals,
                       const u64* coeffs, const i64* offsets, const i64* fidx,
                       i64 T, const i64* aux_offsets, const i64* aux_fidx,
                       i64 A, u64* out){
  i64 half=n/2;
#ifdef MONT52_AVAILABLE
  if(use_ifma() && half >= 8 && (half & 7) == 0){
    // weightless instance: the Gruen IFMA body with no eq tables
    gruen_round_ifma(false, rows, P, n, 0, 0, nevals, coeffs, offsets,
                     fidx, T, aux_offsets, aux_fidx, A,
                     0, 1, 0, 0, -1, out);
    return;
  }
#endif
  const int MAXE=20, MAXP=96, MAXA=16;
  Fr4 total[MAXE];
  for(int t=0;t<nevals;t++) total[t]=Fr4{{0,0,0,0}};
  #pragma omp parallel if(half*P>PAR_THRESH)
  {
    Fr4 local[MAXE];
    for(int t=0;t<nevals;t++) local[t]=Fr4{{0,0,0,0}};
    Fr4 e[MAXP+MAXA][MAXE];
    #pragma omp for schedule(static) nowait
    for(i64 j=0;j<half;j++){
      for(i64 p=0;p<P;p++){
        Fr4 lo,hi,d;
        memcpy(lo.v,rows[p]+j*4,32);
        memcpy(hi.v,rows[p]+(half+j)*4,32);
        e[p][0]=lo;
        if(nevals>1){
          fr_sub(d,hi,lo);
          Fr4 cur=hi;
          for(int t=1;t<nevals;t++){
            fr_add(cur,cur,d);
            e[p][t]=cur;
          }
        }
      }
      for(i64 a=0;a<A;a++){
        for(int t=0;t<nevals;t++){
          Fr4 prod=e[aux_fidx[aux_offsets[a]]][t];
          for(i64 f=aux_offsets[a]+1;f<aux_offsets[a+1];f++)
            fr_mul(prod,prod,e[aux_fidx[f]][t]);
          e[P+a][t]=prod;
        }
      }
      for(int t=0;t<nevals;t++){
        for(i64 k=0;k<T;k++){
          Fr4 prod; memcpy(prod.v,coeffs+k*4,32);
          for(i64 f=offsets[k];f<offsets[k+1];f++)
            fr_mul(prod,prod,e[fidx[f]][t]);
          fr_add(local[t],local[t],prod);
        }
      }
    }
    #pragma omp critical
    for(int t=0;t<nevals;t++) fr_add(total[t],total[t],local[t]);
  }
  for(int t=0;t<nevals;t++) memcpy(out+t*4,total[t].v,32);
}

// in-place HighToLow bind of each row buffer (first half overwritten)
void frv_bind_rows_p(u64* const* rows, i64 P, i64 n, const u64* r){
  Fr4 rc; memcpy(rc.v,r,32);
  i64 half=n/2;
  #pragma omp parallel for schedule(static) collapse(2) if(half*P>PAR_THRESH)
  for(i64 p=0;p<P;p++){
    for(i64 j=0;j<half;j++){
      if(fr4_zero(rows[p]+j*4) && fr4_zero(rows[p]+(half+j)*4))
        continue;  // zero-skip (lo already 0 in place)
      Fr4 lo,hi,d;
      memcpy(lo.v,rows[p]+j*4,32);
      memcpy(hi.v,rows[p]+(half+j)*4,32);
      fr_sub(d,hi,lo);
      fr_mul(d,d,rc);
      fr_add(lo,lo,d);
      memcpy(rows[p]+j*4,lo.v,32);
    }
  }
}

// bind every row HighToLow: out_rows (P, n/2)
void frv_bind_rows(const u64* rows, i64 P, i64 n, const u64* r, u64* out){
  Fr4 rc; memcpy(rc.v,r,32);
  i64 half=n/2;
  #pragma omp parallel for schedule(static) collapse(2) if(half*P>PAR_THRESH)
  for(i64 p=0;p<P;p++){
    for(i64 j=0;j<half;j++){
      Fr4 lo,hi,d;
      memcpy(lo.v,rows+(p*n+j)*4,32);
      memcpy(hi.v,rows+(p*n+half+j)*4,32);
      fr_sub(d,hi,lo);
      fr_mul(d,d,rc);
      fr_add(lo,lo,d);
      memcpy(out+(p*half+j)*4,lo.v,32);
    }
  }
}

// ---- eq table expansion ----------------------------------------------------

// eq(r, x) table over {0,1}^m, interleaved build (r[0] = MSB of the final
// index, matching poly/eq.py): level k doubles the table making r[k] the new
// LSB. out: (2^m, 4). scratch: (2^(m-1), 4). scale: (1,4) Montgomery factor
// folded into the table (pass R1 for none).
void frv_eq_expand(const u64* r, i64 m, const u64* scale, u64* out,
                   u64* scratch){
  Fr4 s; memcpy(s.v, scale, 32);
  memcpy(out, s.v, 32);
  i64 len = 1;
  for(i64 k = 0; k < m; k++){
    Fr4 rk; memcpy(rk.v, r + k*4, 32);
    memcpy(scratch, out, (size_t)len * 32);
#ifdef MONT52_AVAILABLE
    if(use_ifma() && len >= 8){
      using namespace mont52;
      const Interop& io = fr52_io();
      const Ctx& C = io.ctx;
      Fr4 mont16 = R1;
      for(int i=0;i<4;i++) fr_add(mont16, mont16, mont16);
      Fr4 rk16; fr_mul(rk16, rk, mont16);
      V5 rv;
      {
        alignas(64) u64 cols[5][8];
        u64 t[5];
        split52(rk16.v, t);
        for(int j=0;j<5;j++) for(int kk=0;kk<8;kk++) cols[j][kk]=t[j];
        for(int j=0;j<5;j++)
          rv.l[j]=_mm512_load_si512((const void*)cols[j]);
      }
      #pragma omp parallel for schedule(static) if(len > PAR_THRESH)
      for(i64 j = 0; j < len; j += 8){
        V5 cur = to52_8(io, scratch + j*4);
        V5 hi = reduce8(C, mul8(C, cur, rv));
        V5 lo = reduce_full(C, sub8(C, cur, hi));
        alignas(64) u64 chh[5][8], cll[5][8];
        for(int q=0;q<5;q++){
          _mm512_store_si512((void*)chh[q], hi.l[q]);
          _mm512_store_si512((void*)cll[q], lo.l[q]);
        }
        for(int kk=0;kk<8;kk++){
          u64 t[5];
          for(int q=0;q<5;q++) t[q]=cll[q][kk];
          join52(t, out + (2*(j+kk))*4);
          for(int q=0;q<5;q++) t[q]=chh[q][kk];
          join52(t, out + (2*(j+kk)+1)*4);
        }
      }
      len *= 2;
      continue;
    }
#endif
    #pragma omp parallel for schedule(static) if(len > PAR_THRESH)
    for(i64 j = 0; j < len; j++){
      Fr4 cur, hi, lo;
      memcpy(cur.v, scratch + j*4, 32);
      fr_mul(hi, cur, rk);
      fr_sub(lo, cur, hi);
      memcpy(out + (2*j)*4, lo.v, 32);
      memcpy(out + (2*j+1)*4, hi.v, 32);
    }
    len *= 2;
  }
}


// ---- Gruen split-eq fused rounds --------------------------------------------
//
// Round message kernel for instances of the form
//     s(X) = eq_scalar * l_i(X) * q(X),
//     q(t) = sum_j w(j) * sum_terms coeff * prod_f rows[f](pair j at t)
// where the eq factor is NOT a materialized row: w(j) = whi[j >> log_wlo] *
// wlo[j & (2^log_wlo - 1)] (Gruen/Dao-Thaler split-eq; reference
// joltworks/src/poly/split_eq_poly.rs:67). The caller rebuilds the tiny
// whi/wlo suffix tables per round (total O(sqrt n) work) and assembles s(X)
// from the returned q evals at t = 0, 2, ..., nevals.
// whi_n == 1 means the hi table is a folded scalar == R1 (skip the mul);
// log_wlo < 0 means skip the lo lookup (prefix-eq layouts: the weight
// depends only on the high bits, indexed by j >> whi_shift).

static inline bool fr_is_zero(const Fr4&a){
  return (a.v[0]|a.v[1]|a.v[2]|a.v[3])==0;
}

void frv_gruen_round_p(const u64* const* rows, i64 P, i64 n, int nevals,
                       const u64* coeffs, const i64* offsets, const i64* fidx,
                       i64 T, const i64* aux_offsets, const i64* aux_fidx,
                       i64 A, const u64* whi, i64 whi_n, int whi_shift,
                       const u64* wlo, int log_wlo, u64* out){
  i64 half = n/2;
  const int MAXE=20, MAXP=96, MAXA=16;
  const i64 lomask = log_wlo >= 0 ? (((i64)1 << log_wlo) - 1) : 0;
  // single-row degree-2 fast path (opening-reduction / RLC rounds — the
  // dominant call shape): q(0) = coeff * sum_j row[j] * w(j). The whi
  // factor is constant across 2^whi_shift-pair blocks, so it multiplies
  // the BLOCK SUM instead of every pair: ~1 mul/pair instead of ~3
  // (field arithmetic is exact, so regrouping leaves the message
  // byte-identical).
  if(P==1 && nevals==1 && A==0 && T==1 && offsets[1]-offsets[0]==1){
    const bool hl = (whi_n > 1), ll = (log_wlo >= 0);
    const u64* row = rows[0];
    const i64 BS = hl ? ((i64)1 << whi_shift) : half;
    const i64 nblk = (half + BS - 1) / BS;
    Fr4 total{{0,0,0,0}};
    #pragma omp parallel if(half>PAR_THRESH)
    {
      Fr4 loc{{0,0,0,0}};
      #pragma omp for schedule(static) nowait
      for(i64 b=0;b<nblk;b++){
        Fr4 bs{{0,0,0,0}};
        i64 j0=b*BS, j1 = j0+BS < half ? j0+BS : half;
        for(i64 j=j0;j<j1;j++){
          Fr4 v; memcpy(v.v,row+j*4,32);
          if(fr_is_zero(v)) continue;
          if(ll){ Fr4 l; memcpy(l.v,wlo+(j&lomask)*4,32); fr_mul(v,v,l); }
          fr_add(bs,bs,v);
        }
        if(hl){
          Fr4 h; memcpy(h.v,whi+((j0>>whi_shift)&(whi_n-1))*4,32);
          fr_mul(bs,bs,h);
        }
        fr_add(loc,loc,bs);
      }
      #pragma omp critical
      fr_add(total,total,loc);
    }
    Fr4 c0; memcpy(c0.v,coeffs,32);
    if(memcmp(c0.v,R1.v,32)!=0) fr_mul(total,total,c0);
    memcpy(out,total.v,32);
    return;
  }
#ifdef MONT52_AVAILABLE
  if(use_ifma() && half >= 8 && (half & 7) == 0){
    gruen_round_ifma(false, rows, P, n, 0, 0, nevals, coeffs, offsets,
                            fidx, T, aux_offsets, aux_fidx, A, whi,
                            whi_n, whi_shift, wlo, log_wlo, out);
    return;
  }
#endif
  Fr4 total[MAXE];
  for(int t=0;t<nevals;t++) total[t]=Fr4{{0,0,0,0}};
  #pragma omp parallel if(half*P>PAR_THRESH)
  {
    Fr4 local[MAXE];
    for(int t=0;t<nevals;t++) local[t]=Fr4{{0,0,0,0}};
    Fr4 e[MAXP+MAXA][MAXE];
    #pragma omp for schedule(static) nowait
    for(i64 j=0;j<half;j++){
      for(i64 p=0;p<P;p++){
        Fr4 lo,hi,d;
        memcpy(lo.v,rows[p]+j*4,32);
        memcpy(hi.v,rows[p]+(half+j)*4,32);
        e[p][0]=lo;
        if(nevals>1){
          fr_sub(d,hi,lo);
          Fr4 cur=hi;
          for(int t=1;t<nevals;t++){
            fr_add(cur,cur,d);
            e[p][t]=cur;
          }
        }
      }
      for(i64 a=0;a<A;a++){
        for(int t=0;t<nevals;t++){
          Fr4 prod=e[aux_fidx[aux_offsets[a]]][t];
          for(i64 f=aux_offsets[a]+1;f<aux_offsets[a+1];f++){
            if(fr_is_zero(prod)) break;
            fr_mul(prod,prod,e[aux_fidx[f]][t]);
          }
          e[P+a][t]=prod;
        }
      }
      Fr4 w; int wstate = -1;  // -1 not computed, 0 identity, 1 multiply
      for(int t=0;t<nevals;t++){
        Fr4 inner{{0,0,0,0}};
        for(i64 k=0;k<T;k++){
          if(offsets[k+1]==offsets[k]){  // constant term
            Fr4 c; memcpy(c.v,coeffs+k*4,32);
            fr_add(inner,inner,c);
            continue;
          }
          // zero-skip: one-hot / indicator rows make most factors zero
          Fr4 prod=e[fidx[offsets[k]]][t];
          if(fr_is_zero(prod)) continue;
          for(i64 f=offsets[k]+1;f<offsets[k+1];f++){
            fr_mul(prod,prod,e[fidx[f]][t]);
            if(fr_is_zero(prod)) break;
          }
          if(fr_is_zero(prod)) continue;
          Fr4 c; memcpy(c.v,coeffs+k*4,32);
          fr_mul(prod,prod,c);
          fr_add(inner,inner,prod);
        }
        if(fr_is_zero(inner)) continue;
        if(wstate < 0){
          bool set=false;
          if(log_wlo >= 0){ memcpy(w.v, wlo + (j & lomask)*4, 32); set=true; }
          if(whi_n > 1){
            Fr4 h; memcpy(h.v, whi + ((j >> whi_shift)&(whi_n-1))*4, 32);
            if(set) fr_mul(w, w, h); else { w = h; set=true; }
          }
          wstate = set ? 1 : 0;
        }
        if(wstate) fr_mul(inner, inner, w);
        fr_add(local[t],local[t],inner);
      }
    }
    #pragma omp critical
    for(int t=0;t<nevals;t++) fr_add(total[t],total[t],local[t]);
  }
  for(int t=0;t<nevals;t++) memcpy(out+t*4,total[t].v,32);
}

// Fused previous-round bind + current-round message eval: ONE streaming
// pass reads the PRE-bind rows (length n), writes the bound rows (length
// n/2) into out_rows, and accumulates the weighted message evals of the
// post-bind round (n/4 pairs). Binding is HighToLow:
// bound[j] = pre[j] + c (pre[j + n/2] - pre[j]). Replaces the separate
// frv_bind_rows_p pass per round (measured ~51% of the fused engine's
// time was bind passes re-streaming arrays the eval pass just touched).
void frv_gruen_round_bind_p(const u64* const* rows, i64 P, i64 n,
                            const u64* c_prev, u64* const* out_rows,
                            int nevals, const u64* coeffs,
                            const i64* offsets, const i64* fidx, i64 T,
                            const i64* aux_offsets, const i64* aux_fidx,
                            i64 A, const u64* whi, i64 whi_n, int whi_shift,
                            const u64* wlo, int log_wlo, u64* out){
  i64 nb = n/2, half = n/4;
  const int MAXE=20, MAXP=96, MAXA=16;
  const i64 lomask = log_wlo >= 0 ? (((i64)1 << log_wlo) - 1) : 0;
  Fr4 cc; memcpy(cc.v, c_prev, 32);
  // single-row fast path (see frv_gruen_round_p): bind the previous
  // challenge and accumulate q(0) = coeff * sum_j bound[j] * w(j) with the
  // whi factor applied per 2^whi_shift block instead of per pair.
  if(P==1 && nevals==1 && A==0 && T==1 && offsets[1]-offsets[0]==1){
    const bool hl = (whi_n > 1), ll = (log_wlo >= 0);
    const u64* row = rows[0];
    u64* orow = out_rows[0];
    const i64 BS = hl ? ((i64)1 << whi_shift) : half;
    const i64 nblk = BS ? (half + BS - 1) / BS : 0;
    Fr4 total{{0,0,0,0}};
    #pragma omp parallel if(half>PAR_THRESH)
    {
      Fr4 loc{{0,0,0,0}};
      #pragma omp for schedule(static) nowait
      for(i64 b=0;b<nblk;b++){
        Fr4 bs{{0,0,0,0}};
        i64 j0=b*BS, j1 = j0+BS < half ? j0+BS : half;
        for(i64 j=j0;j<j1;j++){
          Fr4 a2,b2,lo,hi,d;
          memcpy(a2.v,row+j*4,32);
          memcpy(b2.v,row+(j+nb)*4,32);
          fr_sub(d,b2,a2); fr_mul(d,d,cc); fr_add(lo,a2,d);
          memcpy(orow+j*4,lo.v,32);
          memcpy(a2.v,row+(j+half)*4,32);
          memcpy(b2.v,row+(j+half+nb)*4,32);
          fr_sub(d,b2,a2); fr_mul(d,d,cc); fr_add(hi,a2,d);
          memcpy(orow+(j+half)*4,hi.v,32);
          if(fr_is_zero(lo)) continue;
          if(ll){ Fr4 l; memcpy(l.v,wlo+(j&lomask)*4,32); fr_mul(lo,lo,l); }
          fr_add(bs,bs,lo);
        }
        if(hl){
          Fr4 h; memcpy(h.v,whi+((j0>>whi_shift)&(whi_n-1))*4,32);
          fr_mul(bs,bs,h);
        }
        fr_add(loc,loc,bs);
      }
      #pragma omp critical
      fr_add(total,total,loc);
    }
    Fr4 c0; memcpy(c0.v,coeffs,32);
    if(memcmp(c0.v,R1.v,32)!=0) fr_mul(total,total,c0);
    memcpy(out,total.v,32);
    return;
  }
#ifdef MONT52_AVAILABLE
  if(use_ifma() && half >= 8 && (half & 7) == 0){
    gruen_round_ifma(true, rows, P, n, c_prev, out_rows, nevals, coeffs,
                           offsets, fidx, T, aux_offsets, aux_fidx, A,
                           whi, whi_n, whi_shift, wlo, log_wlo, out);
    return;
  }
#endif
  Fr4 total[MAXE];
  for(int t=0;t<nevals;t++) total[t]=Fr4{{0,0,0,0}};
  #pragma omp parallel if(half*P>PAR_THRESH)
  {
    Fr4 local[MAXE];
    for(int t=0;t<nevals;t++) local[t]=Fr4{{0,0,0,0}};
    Fr4 e[MAXP+MAXA][MAXE];
    #pragma omp for schedule(static) nowait
    for(i64 j=0;j<half;j++){
      for(i64 p=0;p<P;p++){
        Fr4 a,b,lo,hi,d;
        memcpy(a.v,rows[p]+j*4,32);
        memcpy(b.v,rows[p]+(j+nb)*4,32);
        fr_sub(d,b,a); fr_mul(d,d,cc); fr_add(lo,a,d);
        memcpy(out_rows[p]+j*4,lo.v,32);
        memcpy(a.v,rows[p]+(j+half)*4,32);
        memcpy(b.v,rows[p]+(j+half+nb)*4,32);
        fr_sub(d,b,a); fr_mul(d,d,cc); fr_add(hi,a,d);
        memcpy(out_rows[p]+(j+half)*4,hi.v,32);
        e[p][0]=lo;
        if(nevals>1){
          fr_sub(d,hi,lo);
          Fr4 cur=hi;
          for(int t=1;t<nevals;t++){
            fr_add(cur,cur,d);
            e[p][t]=cur;
          }
        }
      }
      for(i64 a=0;a<A;a++){
        for(int t=0;t<nevals;t++){
          Fr4 prod=e[aux_fidx[aux_offsets[a]]][t];
          for(i64 f=aux_offsets[a]+1;f<aux_offsets[a+1];f++){
            if(fr_is_zero(prod)) break;
            fr_mul(prod,prod,e[aux_fidx[f]][t]);
          }
          e[P+a][t]=prod;
        }
      }
      Fr4 w; int wstate = -1;
      for(int t=0;t<nevals;t++){
        Fr4 inner{{0,0,0,0}};
        for(i64 k=0;k<T;k++){
          if(offsets[k+1]==offsets[k]){
            Fr4 c; memcpy(c.v,coeffs+k*4,32);
            fr_add(inner,inner,c);
            continue;
          }
          Fr4 prod=e[fidx[offsets[k]]][t];
          if(fr_is_zero(prod)) continue;
          for(i64 f=offsets[k]+1;f<offsets[k+1];f++){
            fr_mul(prod,prod,e[fidx[f]][t]);
            if(fr_is_zero(prod)) break;
          }
          if(fr_is_zero(prod)) continue;
          Fr4 c; memcpy(c.v,coeffs+k*4,32);
          fr_mul(prod,prod,c);
          fr_add(inner,inner,prod);
        }
        if(fr_is_zero(inner)) continue;
        if(wstate < 0){
          bool set=false;
          if(log_wlo >= 0){ memcpy(w.v, wlo + (j & lomask)*4, 32); set=true; }
          if(whi_n > 1){
            Fr4 h; memcpy(h.v, whi + ((j >> whi_shift)&(whi_n-1))*4, 32);
            if(set) fr_mul(w, w, h); else { w = h; set=true; }
          }
          wstate = set ? 1 : 0;
        }
        if(wstate) fr_mul(inner, inner, w);
        fr_add(local[t],local[t],inner);
      }
    }
    #pragma omp critical
    for(int t=0;t<nevals;t++) fr_add(total[t],total[t],local[t]);
  }
  for(int t=0;t<nevals;t++) memcpy(out+t*4,total[t].v,32);
}

// Fleet variant of the single-row degree-2 round: ALL such instances of a
// batched sumcheck round in ONE call — K ~ 150 opening-reduction groups
// per round each previously paid their own kernel launch and a poorly
// load-balanced parallel region. Per instance k: optionally bind the
// SHARED previous challenge c (binds[k] != 0) writing out_rows[k]
// (length ns[k]/2), then q0_k = sum_j bound[j] * w_k(j) with the whi
// factor applied per 2^whi_shift block — the identical regrouping as the
// P==1 fast paths of frv_gruen_round_p / frv_gruen_round_bind_p, so the
// messages stay byte-identical. Parallelism: dynamic over instances
// (sizes vary by orders of magnitude).

void frv_gruen1_fleet(const u64* const* rows, u64* const* out_rows,
                      const i64* ns, const i64* binds, i64 K,
                      const u64* c_prev,
                      const u64* const* whis, const i64* whi_ns,
                      const i64* whi_shifts,
                      const u64* const* wlos, const i64* log_wlos,
                      u64* out){
  Fr4 cc; memcpy(cc.v, c_prev, 32);
#ifdef MONT52_AVAILABLE
  const int have52 = use_ifma();
#else
  const int have52 = 0;
#endif
  #pragma omp parallel for schedule(dynamic, 1)
  for(i64 k=0;k<K;k++){
    const u64* row = rows[k];
    const i64 n = ns[k];
    const bool bind = binds[k] != 0;
    const i64 half = bind ? n/4 : n/2;
    const i64 nb = n/2;
    u64* orow = bind ? out_rows[k] : 0;
    const u64* whi = whis[k];
    const i64 whi_n = whi_ns[k];
    const int shift = (int)whi_shifts[k];
    const u64* wlo = wlos[k];
    const int log_wlo = (int)log_wlos[k];
#ifdef MONT52_AVAILABLE
    {
      const i64 BSv = (whi_n > 1) ? ((i64)1 << shift) : half;
      if(have52 && half >= 8 && (half & 7) == 0 && BSv >= 8
         && (BSv & 7) == 0 && (log_wlo < 0 || log_wlo >= 3)){
        gruen1_ifma(row, orow, n, bind, c_prev, whi, whi_n, shift,
                    wlo, log_wlo, out + k*4);
        continue;
      }
    }
#endif
    const bool hl = whi_n > 1, ll = log_wlo >= 0;
    const i64 lomask = ll ? (((i64)1 << log_wlo) - 1) : 0;
    const i64 BS = hl ? ((i64)1 << shift) : half;
    const i64 nblk = BS ? (half + BS - 1) / BS : 0;
    Fr4 total{{0,0,0,0}};
    for(i64 b=0;b<nblk;b++){
      Fr4 bs{{0,0,0,0}};
      i64 j0=b*BS, j1 = j0+BS < half ? j0+BS : half;
      for(i64 j=j0;j<j1;j++){
        Fr4 lo;
        if(bind){
          Fr4 a2,b2,hi,d;
          memcpy(a2.v,row+j*4,32);
          memcpy(b2.v,row+(j+nb)*4,32);
          fr_sub(d,b2,a2); fr_mul(d,d,cc); fr_add(lo,a2,d);
          memcpy(orow+j*4,lo.v,32);
          memcpy(a2.v,row+(j+half)*4,32);
          memcpy(b2.v,row+(j+half+nb)*4,32);
          fr_sub(d,b2,a2); fr_mul(d,d,cc); fr_add(hi,a2,d);
          memcpy(orow+(j+half)*4,hi.v,32);
        } else {
          memcpy(lo.v,row+j*4,32);
        }
        if(fr_is_zero(lo)) continue;
        if(ll){ Fr4 l; memcpy(l.v,wlo+(j&lomask)*4,32); fr_mul(lo,lo,l); }
        fr_add(bs,bs,lo);
      }
      if(hl){
        Fr4 h; memcpy(h.v,whi+((j0>>shift)&(whi_n-1))*4,32);
        fr_mul(bs,bs,h);
      }
      fr_add(total,total,bs);
    }
    memcpy(out+k*4,total.v,32);
  }
}

// Fleet variant of the two-row product instances (chunk-table read checks:
// rows = [table, G], term = table*G, degree 2 over tiny 16-slot domains).
// A bench prove runs ~2,400 such instances x 4 rounds; per-instance kernel
// launches were pure dispatch overhead. One call per batched round: per
// instance m, optionally bind the SHARED previous challenge (binds[m])
// writing the two bound rows into orows[2m]/orows[2m+1] (length ns[m]/2),
// then accumulate the degree-2 ladder [q(0), q(2)] of the post-bind round.
// Field arithmetic is exact, so the evals match the per-instance kernel
// (frv_terms_round_p) bit for bit.
void frv_pair_fleet(const u64* const* rows, u64* const* orows,
                    const i64* ns, const i64* binds, i64 M,
                    const u64* c_prev, u64* out){
  Fr4 cc; memcpy(cc.v, c_prev, 32);
  #pragma omp parallel for schedule(dynamic, 8) if(M>32)
  for(i64 m=0;m<M;m++){
    const u64 *ra=rows[2*m], *rb=rows[2*m+1];
    const i64 n=ns[m];
    const bool bind = binds[m] != 0;
    const i64 nb=n/2, half = bind ? n/4 : n/2;
    u64 *oa=orows[2*m], *ob=orows[2*m+1];
    Fr4 q0{{0,0,0,0}}, q2{{0,0,0,0}};
    for(i64 j=0;j<half;j++){
      Fr4 loA,hiA,loB,hiB;
      if(bind){
        Fr4 x,y,d;
        memcpy(x.v,ra+j*4,32); memcpy(y.v,ra+(j+nb)*4,32);
        fr_sub(d,y,x); fr_mul(d,d,cc); fr_add(loA,x,d);
        memcpy(oa+j*4,loA.v,32);
        memcpy(x.v,ra+(j+half)*4,32); memcpy(y.v,ra+(j+half+nb)*4,32);
        fr_sub(d,y,x); fr_mul(d,d,cc); fr_add(hiA,x,d);
        memcpy(oa+(j+half)*4,hiA.v,32);
        memcpy(x.v,rb+j*4,32); memcpy(y.v,rb+(j+nb)*4,32);
        fr_sub(d,y,x); fr_mul(d,d,cc); fr_add(loB,x,d);
        memcpy(ob+j*4,loB.v,32);
        memcpy(x.v,rb+(j+half)*4,32); memcpy(y.v,rb+(j+half+nb)*4,32);
        fr_sub(d,y,x); fr_mul(d,d,cc); fr_add(hiB,x,d);
        memcpy(ob+(j+half)*4,hiB.v,32);
      } else {
        memcpy(loA.v,ra+j*4,32); memcpy(hiA.v,ra+(j+half)*4,32);
        memcpy(loB.v,rb+j*4,32); memcpy(hiB.v,rb+(j+half)*4,32);
      }
      if(!(fr_is_zero(loA) || fr_is_zero(loB))){
        Fr4 p0; fr_mul(p0, loA, loB); fr_add(q0,q0,p0);
      }
      Fr4 dA; fr_sub(dA,hiA,loA); Fr4 e2A; fr_add(e2A,hiA,dA);
      Fr4 dB; fr_sub(dB,hiB,loB); Fr4 e2B; fr_add(e2B,hiB,dB);
      if(!(fr_is_zero(e2A) || fr_is_zero(e2B))){
        Fr4 p2; fr_mul(p2,e2A,e2B); fr_add(q2,q2,p2);
      }
    }
    memcpy(out+m*8, q0.v, 32);
    memcpy(out+m*8+4, q2.v, 32);
  }
}

// Single-limb Montgomery product: out = a * b / 2^256 mod r. To multiply a
// Montgomery-form value w (= w_canon * R) by a plain u64 AND keep Montgomery
// form, first scale once: W2 = fr_mul(w, R2) = w_canon * R^2; then
// fr_mul_u64(W2, b) = w_canon * b * R — the Montgomery form of w*b, at less
// than half the cost of a full fr_mul per use.
static inline void fr_mul_u64(Fr4&out, const Fr4&a, u64 b){
  u64 t[5]={0,0,0,0,0};
  u128 carry=0;
  for(int j=0;j<4;j++){
    u128 cur=(u128)a.v[j]*b+carry;
    t[j]=(u64)cur; carry=cur>>64;
  }
  t[4]=(u64)carry;
  // 4 reduction steps (one per limb of the implicit zero-extended operand)
  for(int i=0;i<4;i++){
    u64 m=t[0]*R_INV;
    u128 cur=(u128)t[0]+(u128)m*R_MOD.v[0];
    carry=cur>>64;
    for(int j=1;j<4;j++){
      cur=(u128)t[j]+(u128)m*R_MOD.v[j]+carry;
      t[j-1]=(u64)cur; carry=cur>>64;
    }
    u128 s=(u128)t[4]+carry;
    t[3]=(u64)s;
    t[4]=(u64)(s>>64);
  }
  Fr4 r={{t[0],t[1],t[2],t[3]}};
  if(t[4] || ge(r,R_MOD)) sub_nocheck(r,r,R_MOD);
  out=r;
}

// 2^64 in Montgomery form (2^320 mod r), for splitting u128 payloads
static const Fr4 TWO64M = {{0xb4c6edf97c5fb586ULL, 0x708c8d50bfeb93beULL,
                            0x9ffd1de404f7e0efULL, 0x215b02ac9a392866ULL}};

// Integer-row variant of the Gruen round for round 0 of instances whose
// rows are still small integers (chunk nibbles, indicator bits, i32 witness
// values) and whose coefficients are signed 64-bit integers. The inner
// per-pair term sum S_j(t) is computed exactly in signed 128-bit arithmetic
// (the Python side verifies the static bound |S| < 2^126 before choosing
// this kernel), then folded into the field accumulator with 1-2 single-limb
// Montgomery muls: w * S = w*lo(S) + (w*2^64)*hi(S). Zero S_j (the common
// case for indicator-gated terms) skips all field work for the pair.
typedef __int128 i128;

// Shared per-pair weight fetch: R2-prescaled Montgomery weight (so a
// following fr_mul_u64 lands back in Montgomery form). Returns false when
// there is no weight at all (w = 1; caller should use the R2 constant).
static inline bool gruen_weight(i64 j, const u64* whi, i64 whi_n,
                                int whi_shift, const u64* wlo, int log_wlo,
                                i64 lomask, Fr4& w){
  bool set=false;
  if(log_wlo >= 0){ memcpy(w.v, wlo + (j & lomask)*4, 32); set=true; }
  if(whi_n > 1){
    Fr4 h; memcpy(h.v, whi + ((j >> whi_shift)&(whi_n-1))*4, 32);
    if(set) fr_mul(w, w, h); else { w = h; set=true; }
  }
  if(set) fr_mul(w, w, R2);
  return set;
}

// Integer-weighted field dot: out = sum_i v[i] * x[i] with v signed i64
// and x Montgomery rows (out Montgomery). Each term costs ONE single-limb
// Montgomery multiply in the canonical domain (fr_mul_u64(x_mont, |v|) =
// x_canon * |v|) instead of an i64->Montgomery encode plus a full
// multiply — the MLE-evaluation hot path for integer witness/constant
// polynomials (reference compact_polynomial.rs evaluate over small
// scalars). |v| up to 2^127 via the TWO64M split; zero weights skip.
void frv_i64_dot(const i64* v, const u64* x, i64 n, u64* out){
  Fr4 total={{0,0,0,0}};
  #pragma omp parallel if(n>PAR_THRESH)
  {
    Fr4 local={{0,0,0,0}};
    #pragma omp for schedule(static) nowait
    for(i64 i=0;i<n;i++){
      i64 w=v[i];
      if(!w) continue;
      Fr4 xe; memcpy(xe.v,x+i*4,32);
      u64 mag = w<0 ? (u64)(-(u128)w) : (u64)w;
      Fr4 p;
      fr_mul_u64(p, xe, mag);
      if(w<0) fr_sub(local,local,p); else fr_add(local,local,p);
    }
    #pragma omp critical
    fr_add(total,total,local);
  }
  // canonical-domain accumulator -> Montgomery form
  fr_mul(total,total,R2);
  memcpy(out,total.v,32);
}

// Factored integer MLE evaluation: out = sum_{r,c} v[r*C + c] *
// eq_hi[r] * eq_lo[c] — i.e. eq_hi^T (V eq_lo) — so a 2^m-point
// evaluation needs two 2^(m/2) eq tables instead of one 2^m table
// (the 2^26-coefficient GPT-2 constants otherwise build 2 GB eq tables
// per opening). Same arithmetic plan as frv_i64_dot: one single-limb
// canonical multiply per nonzero coefficient, one full multiply per row.
void frv_i64_dot2(const i64* v, i64 R, i64 C, const u64* eq_hi,
                  const u64* eq_lo, u64* out){
  Fr4 total={{0,0,0,0}};
  #pragma omp parallel if(R*C>PAR_THRESH)
  {
    Fr4 local={{0,0,0,0}};
    #pragma omp for schedule(static) nowait
    for(i64 r=0;r<R;r++){
      const i64* row = v + r*C;
      Fr4 inner={{0,0,0,0}};
      bool any=false;
      for(i64 c=0;c<C;c++){
        i64 w=row[c];
        if(!w) continue;
        Fr4 xe; memcpy(xe.v,eq_lo+c*4,32);
        u64 mag = w<0 ? (u64)(-(u128)w) : (u64)w;
        Fr4 p;
        fr_mul_u64(p, xe, mag);
        if(w<0) fr_sub(inner,inner,p); else fr_add(inner,inner,p);
        any=true;
      }
      if(!any) continue;
      Fr4 h; memcpy(h.v,eq_hi+r*4,32);
      Fr4 t; fr_mul(t,inner,h);
      fr_add(local,local,t);
    }
    #pragma omp critical
    fr_add(total,total,local);
  }
  fr_mul(total,total,R2);   // canonical accumulator -> Montgomery
  memcpy(out,total.v,32);
}

void frv_gruen_round0_i64(const i64* const* rows, i64 P, i64 n, int nevals,
                          const i64* coeffs, const i64* offsets,
                          const i64* fidx, i64 T, const u64* whi, i64 whi_n,
                          int whi_shift, const u64* wlo, int log_wlo,
                          u64* out){
  i64 half = n/2;
  const int MAXE=20, MAXP=96;
  const i64 lomask = log_wlo >= 0 ? (((i64)1 << log_wlo) - 1) : 0;
  Fr4 total[MAXE];
  for(int t=0;t<nevals;t++) total[t]=Fr4{{0,0,0,0}};
  #pragma omp parallel if(half>PAR_THRESH/4)
  {
    Fr4 local[MAXE];
    for(int t=0;t<nevals;t++) local[t]=Fr4{{0,0,0,0}};
    i64 e[MAXP][MAXE];
    #pragma omp for schedule(static) nowait
    for(i64 j=0;j<half;j++){
      for(i64 p=0;p<P;p++){
        i64 lo=rows[p][j], hi=rows[p][half+j];
        e[p][0]=lo;
        if(nevals>1){
          i64 d=hi-lo, cur=hi;
          for(int t=1;t<nevals;t++){ cur+=d; e[p][t]=cur; }
        }
      }
      Fr4 w; bool have_w=false, wset=false;
      for(int t=0;t<nevals;t++){
        i128 S=0;
        for(i64 k=0;k<T;k++){
          i128 prod=coeffs[k];
          for(i64 f=offsets[k];f<offsets[k+1];f++){
            i64 v=e[fidx[f]][t];
            if(!v){ prod=0; break; }
            prod*=v;
          }
          S+=prod;
        }
        if(!S) continue;
        if(!have_w){
          wset = gruen_weight(j, whi, whi_n, whi_shift, wlo, log_wlo,
                              lomask, w);
          if(!wset) w = R2;  // identity weight, R2-prescaled
          have_w=true;
        }
        bool neg = S<0;
        u128 mag = neg ? (u128)(-S) : (u128)S;
        Fr4 c;
        fr_mul_u64(c, w, (u64)mag);
        if(mag >> 64){
          Fr4 chi;
          fr_mul_u64(chi, w, (u64)(mag >> 64));
          fr_mul(chi, chi, TWO64M);
          fr_add(c, c, chi);
        }
        if(neg) fr_sub(local[t], local[t], c);
        else    fr_add(local[t], local[t], c);
      }
    }
    #pragma omp critical
    for(int t=0;t<nevals;t++) fr_add(total[t],total[t],local[t]);
  }
  for(int t=0;t<nevals;t++) memcpy(out+t*4,total[t].v,32);
}

// Fr-coefficient variant of the integer round-0 kernel: rows are small
// integers but the term coefficients are full field elements (Booleanity's
// batching gammas). Per (pair, eval, term): exact i128 factor product
// (zero-skip), folded as coeff_k * prod via 1-2 single-limb Montgomery
// muls; the per-pair weight then multiplies the term sum once. coeffs are
// R2-PRESCALED Montgomery limbs (caller multiplies by R2 once at setup).
void frv_gruen_round0_i64fr(const i64* const* rows, i64 P, i64 n, int nevals,
                            const u64* coeffs, const i64* offsets,
                            const i64* fidx, i64 T, const u64* whi, i64 whi_n,
                            int whi_shift, const u64* wlo, int log_wlo,
                            u64* out){
  i64 half = n/2;
  const int MAXE=20, MAXP=96;
  const i64 lomask = log_wlo >= 0 ? (((i64)1 << log_wlo) - 1) : 0;
  Fr4 total[MAXE];
  for(int t=0;t<nevals;t++) total[t]=Fr4{{0,0,0,0}};
  #pragma omp parallel if(half>PAR_THRESH/4)
  {
    Fr4 local[MAXE];
    for(int t=0;t<nevals;t++) local[t]=Fr4{{0,0,0,0}};
    i64 e[MAXP][MAXE];
    #pragma omp for schedule(static) nowait
    for(i64 j=0;j<half;j++){
      for(i64 p=0;p<P;p++){
        i64 lo=rows[p][j], hi=rows[p][half+j];
        e[p][0]=lo;
        if(nevals>1){
          i64 d=hi-lo, cur=hi;
          for(int t=1;t<nevals;t++){ cur+=d; e[p][t]=cur; }
        }
      }
      Fr4 w; int wstate=-1;
      for(int t=0;t<nevals;t++){
        Fr4 S{{0,0,0,0}}; bool any=false;
        for(i64 k=0;k<T;k++){
          i128 prod=1;
          for(i64 f=offsets[k];f<offsets[k+1];f++){
            i64 v=e[fidx[f]][t];
            if(!v){ prod=0; break; }
            prod*=v;
          }
          if(!prod) continue;
          Fr4 cf; memcpy(cf.v, coeffs + k*4, 32);  // R2-prescaled
          bool neg = prod<0;
          u128 mag = neg ? (u128)(-prod) : (u128)prod;
          Fr4 c;
          fr_mul_u64(c, cf, (u64)mag);
          if(mag >> 64){
            Fr4 chi;
            fr_mul_u64(chi, cf, (u64)(mag >> 64));
            fr_mul(chi, chi, TWO64M);
            fr_add(c, c, chi);
          }
          if(neg) fr_sub(S, S, c); else fr_add(S, S, c);
          any=true;
        }
        if(!any || fr_is_zero(S)) continue;
        if(wstate < 0){
          Fr4 wraw;
          bool set=false;
          if(log_wlo >= 0){ memcpy(wraw.v, wlo + (j & lomask)*4, 32); set=true; }
          if(whi_n > 1){
            Fr4 h; memcpy(h.v, whi + ((j >> whi_shift)&(whi_n-1))*4, 32);
            if(set) fr_mul(wraw, wraw, h); else { wraw = h; set=true; }
          }
          if(set){ w = wraw; wstate = 1; } else wstate = 0;
        }
        if(wstate) fr_mul(S, S, w);
        fr_add(local[t], local[t], S);
      }
    }
    #pragma omp critical
    for(int t=0;t<nevals;t++) fr_add(total[t],total[t],local[t]);
  }
  for(int t=0;t<nevals;t++) memcpy(out+t*4,total[t].v,32);
}

// Bind integer rows with a field challenge -> Montgomery rows:
// out[j] = mont(lo_j) + r * (hi_j - lo_j), one output buffer per row.
void frv_bind_rows_i64(const i64* const* rows, i64 P, i64 n, const u64* r,
                       u64* const* out){
  Fr4 rc; memcpy(rc.v,r,32);
  Fr4 rc2; fr_mul(rc2, rc, R2);  // R2-scaled for single-limb Montgomery muls
  i64 half=n/2;
  #pragma omp parallel for schedule(static) collapse(2) if(half*P>PAR_THRESH)
  for(i64 p=0;p<P;p++){
    for(i64 j=0;j<half;j++){
      i64 lo=rows[p][j];
      i64 d=rows[p][half+j]-lo;
      Fr4 acc={{0,0,0,0}};
      if(d){
        u64 mag = d<0 ? (u64)(-d) : (u64)d;
        fr_mul_u64(acc, rc2, mag);
        if(d<0){ Fr4 z={{0,0,0,0}}; fr_sub(acc, z, acc); }
      }
      if(lo){
        Fr4 lom={{0,0,0,0}};
        if(lo>=0){ lom.v[0]=(u64)lo; }
        else {
          u64 mag=(u64)(-lo);
          Fr4 m={{mag,0,0,0}}; sub_nocheck(lom,R_MOD,m);
        }
        Fr4 lomm; fr_mul(lomm, lom, R2);
        fr_add(acc, acc, lomm);
      }
      memcpy(out[p]+j*4, acc.v, 32);
    }
  }
}

// ---- small univariate (round message) kernels ------------------------------
//
// The batched-sumcheck round loop runs tens of thousands of tiny univariate
// operations (interpolate a degree <= 20 message, scale-accumulate it into
// the batched poly, evaluate at the round challenge). Doing these per-
// coefficient in Python Fr costs ~0.5 us/mul plus object churn; these
// kernels take the whole poly in one call on Montgomery limb rows
// (reference counterpart: the UniPoly ops of joltworks/src/poly/unipoly.rs
// running on arkworks field elements).

// out = M @ x for a small n x n Montgomery matrix (row-major)
void frv_matvec_small(const u64* M, const u64* x, i64 n, u64* out){
  for(i64 i=0;i<n;i++){
    Fr4 acc={{0,0,0,0}};
    for(i64 j=0;j<n;j++){
      const u64* m = M + (i*n+j)*4;
      if((m[0]|m[1]|m[2]|m[3])==0) continue;
      Fr4 a,b,p;
      memcpy(a.v,m,32); memcpy(b.v,x+j*4,32);
      fr_mul(p,a,b);
      fr_add(acc,acc,p);
    }
    memcpy(out+i*4,acc.v,32);
  }
}

// UniPoly coefficients from the sumcheck eval ladder + claim hint:
// full = [e0, hint - e0, e1, ..., e_{nev-1}] (evals at 0, 1, 2, ..., nev),
// out = vinv @ full  with vinv the (nev+1)x(nev+1) inverse Vandermonde.
void frv_unipoly_hint_interp(const u64* evals, i64 nev, const u64* hint,
                             const u64* vinv, u64* out){
  const i64 n = nev + 1;
  Fr4 full[24];
  memcpy(full[0].v, evals, 32);
  Fr4 h; memcpy(h.v, hint, 32);
  fr_sub(full[1], h, full[0]);
  for(i64 i=1;i<nev;i++) memcpy(full[i+1].v, evals+i*4, 32);
  frv_matvec_small(vinv, (const u64*)full, n, out);
}

// Gruen round assembly (sumcheck.py _gruen_assemble): from the weighted
// product evals qev = [q(0), q(2), ..., q(nq)] recover
//   q(1) = (claim * es_inv - l0 * q(0)) * l1_inv,
// interpolate q (nq+1 coeffs via vinv), then emit
//   s(X) = es * (l0 + X*(l1 - l0)) * q(X)   (nq+2 coefficients).
// es == R1 (identity) skips the final scaling.
void frv_gruen_assemble(const u64* qev, i64 nq, const u64* claim,
                        const u64* es, const u64* es_inv, const u64* l0,
                        const u64* l1, const u64* l1_inv, const u64* vinv,
                        u64* out){
  const i64 n = nq + 1;          // q coefficient count
  Fr4 full[24], q[24];
  Fr4 cl, e_inv, L0, L1, L1i;
  memcpy(cl.v, claim, 32); memcpy(e_inv.v, es_inv, 32);
  memcpy(L0.v, l0, 32); memcpy(L1.v, l1, 32); memcpy(L1i.v, l1_inv, 32);
  memcpy(full[0].v, qev, 32);
  Fr4 t0, t1;
  fr_mul(t0, cl, e_inv);
  fr_mul(t1, L0, full[0]);
  fr_sub(t0, t0, t1);
  fr_mul(full[1], t0, L1i);
  for(i64 i=1;i<nq;i++) memcpy(full[i+1].v, qev+i*4, 32);
  frv_matvec_small(vinv, (const u64*)full, n, (u64*)q);
  // s = l0*q + X*(l1-l0)*q
  Fr4 b; fr_sub(b, L1, L0);
  Fr4 s[25];
  for(i64 i=0;i<n+1;i++) s[i]=Fr4{{0,0,0,0}};
  for(i64 i=0;i<n;i++){
    Fr4 p;
    fr_mul(p, L0, q[i]);
    fr_add(s[i], s[i], p);
    fr_mul(p, b, q[i]);
    fr_add(s[i+1], s[i+1], p);
  }
  Fr4 esv; memcpy(esv.v, es, 32);
  if(memcmp(esv.v, R1.v, 32) != 0)
    for(i64 i=0;i<n+1;i++) fr_mul(s[i], s[i], esv);
  memcpy(out, s, (size_t)(n+1)*32);
}

// Batched-round accumulate: acc[:lens[i]] += scalars[i] * polys[i] for all
// K instance messages in ONE call (replaces one axpy call per instance per
// round — ~42k ctypes crossings per nanoGPT prove).
void frv_axpy_multi(u64* acc, const u64* const* ptrs, const i64* lens,
                    const u64* scalars, i64 K){
  for(i64 i=0;i<K;i++){
    Fr4 s; memcpy(s.v, scalars+i*4, 32);
    const u64* p = ptrs[i];
    for(i64 j=0;j<lens[i];j++){
      Fr4 x,o;
      memcpy(x.v,p+j*4,32);
      fr_mul(x,x,s);
      memcpy(o.v,acc+j*4,32);
      fr_add(o,o,x);
      memcpy(acc+j*4,o.v,32);
    }
  }
}

// Batched Horner: out[i] = polys[i](r) for all K instance messages in ONE
// call (the per-round individual-claim update of BatchedSumcheck).
void frv_horner_multi(const u64* const* ptrs, const i64* lens, i64 K,
                      const u64* r, u64* out){
  Fr4 rr; memcpy(rr.v, r, 32);
  for(i64 i=0;i<K;i++){
    const u64* p = ptrs[i];
    i64 n = lens[i];
    Fr4 acc={{0,0,0,0}};
    for(i64 j=n-1;j>=0;j--){
      Fr4 c; memcpy(c.v,p+j*4,32);
      fr_mul(acc,acc,rr);
      fr_add(acc,acc,c);
    }
    memcpy(out+i*4,acc.v,32);
  }
}

// Verifier round-claim chain step: coeffs c = [c0, c2, c3, ...] are the
// COMPRESSED round polynomial (linear term omitted); recover
// lin = hint - 2 c0 - sum(c[1:]) and return
// P(x) = c0 + lin*x + x^2 * (c[1] + c[2] x + ...). All Montgomery; the
// running claim never leaves limb form across the round chain.
void frv_eval_from_hint(const u64* c, i64 n, const u64* hint,
                        const u64* x, u64* out){
  Fr4 c0; memcpy(c0.v, c, 32);
  Fr4 h; memcpy(h.v, hint, 32);
  Fr4 xx; memcpy(xx.v, x, 32);
  Fr4 lin; fr_sub(lin, h, c0); fr_sub(lin, lin, c0);
  Fr4 tail{{0,0,0,0}};
  for(i64 i=n-1;i>=1;i--){
    Fr4 ci; memcpy(ci.v, c+i*4, 32);
    fr_sub(lin, lin, ci);
    fr_mul(tail, tail, xx);
    fr_add(tail, tail, ci);
  }
  // P = c0 + x*(lin + x*tail)
  Fr4 acc;
  fr_mul(acc, tail, xx);
  fr_add(acc, acc, lin);
  fr_mul(acc, acc, xx);
  fr_add(acc, acc, c0);
  memcpy(out, acc.v, 32);
}

// Field inversion, Montgomery-batched (in/out Montgomery form). One
// Fermat exponentiation (a^(p-2), ~254 squarings) is shared across the
// whole batch via prefix products; singles cost ~6 us vs CPython's ~22 us
// extended-Euclid bigint pow(v, -1, r). Zero inputs map to zero.
static void fr_fermat_inv(Fr4& out, const Fr4& a){
  // exponent p-2, little-endian limbs
  static const u64 E[4] = {0x43e1f593efffffffULL, 0x2833e84879b97091ULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL};
  Fr4 acc = R1, base = a;
  for(int limb=0; limb<4; limb++){
    u64 e = E[limb];
    for(int bit=0; bit<64; bit++){
      if(e & 1) fr_mul(acc, acc, base);
      e >>= 1;
      if(limb==3 && e==0) break;
      fr_mul(base, base, base);
    }
  }
  out = acc;
}

void frv_inv(const u64* in, u64* out, i64 n){
  if(n <= 0) return;
  std::vector<Fr4> pre((size_t)n);
  Fr4 run = R1;
  for(i64 i=0;i<n;i++){
    pre[i] = run;                       // product of nonzeros before i
    Fr4 a; memcpy(a.v, in+i*4, 32);
    if(!fr_is_zero(a)) fr_mul(run, run, a);
  }
  Fr4 inv_all; fr_fermat_inv(inv_all, run);
  for(i64 i=n-1;i>=0;i--){
    Fr4 a; memcpy(a.v, in+i*4, 32);
    if(fr_is_zero(a)){ memset(out+i*4, 0, 32); continue; }
    Fr4 o; fr_mul(o, inv_all, pre[i]);
    memcpy(out+i*4, o.v, 32);
    fr_mul(inv_all, inv_all, a);
  }
}

// Canonical-form batch inversion: encode -> Fermat/Montgomery-batch ->
// decode in ONE call (the separate encode/decode kernel calls cost more
// ctypes overhead than the inversion itself for singletons).
void frv_inv_canon(const u64* in, u64* out, i64 n){
  std::vector<Fr4> enc((size_t)n);
  for(i64 i=0;i<n;i++){
    Fr4 a; memcpy(a.v, in+i*4, 32);
    fr_mul(enc[i], a, R2);
  }
  frv_inv((const u64*)enc.data(), (u64*)enc.data(), n);
  Fr4 one{{1,0,0,0}};
  for(i64 i=0;i<n;i++){
    Fr4 o; fr_mul(o, enc[i], one);   // Montgomery reduce to canonical
    memcpy(out+i*4, o.v, 32);
  }
}

// Batched one-hot RLC accumulation, cycle-partitioned: every member has
// exactly one flat position per cycle k with position ≡ k (mod T), and all
// members in an opening group share T, so threads owning disjoint k-ranges
// can never write the same output word — one streaming pass, no atomics,
// and none of frv_scatter_const_ranges' per-thread full-stream rescans
// (that kernel remains the fallback for unequal member lengths).
void frv_scatter_cycles(const u64* gammas, i64 nmemb,
                        const i64* const* idx, i64 T, u64* out){
  #pragma omp parallel if(nmemb*T>PAR_THRESH)
  {
    int nt=omp_get_num_threads(), t=omp_get_thread_num();
    i64 lo=T*(i64)t/nt, hi=T*(i64)(t+1)/nt;
    for(i64 m=0;m<nmemb;m++){
      Fr4 g; memcpy(g.v,gammas+m*4,32);
      const i64* ix=idx[m];
      for(i64 k=lo;k<hi;k++){
        i64 p=ix[k];
        Fr4 o; memcpy(o.v,out+p*4,32);
        fr_add(o,o,g);
        memcpy(out+p*4,o.v,32);
      }
    }
  }
}

// Sparse one-hot Booleanity address-round message (onehot.py _phase1_qev):
// for each chunk d the partially-bound one-hot has exactly one nonzero per
// cycle j, at value c = idx[d][j], worth U[c] times the split-eq pair
// weight w(p), p = ((c & (bit-1)) << logT) + j. The round evals reduce to
// K-bucket weight sums G_d[c] = sum_j w(p) [idx[d][j] == c], combined with
// U / U^2 and the current address bit. One streaming pass over (D, T)
// replaces the per-chunk gather/mul/scatter/mask chain the Python layer
// ran (measured ~16% of prove as FrArray temporaries at bench scale).
// out = [q(0), q(2)] as Montgomery limbs.
void frv_onehot_qev(const i64* const* idx, i64 D, i64 T,
                    const u64* U, i64 K,
                    const u64* whi, i64 whi_n, int whi_shift,
                    const u64* wlo, int log_wlo,
                    int low_bits, int logT,
                    const u64* gammas, u64* out){
  const i64 lomask = log_wlo >= 0 ? (((i64)1 << log_wlo) - 1) : 0;
  const i64 bitmask = ((i64)1 << low_bits) - 1;
  static_assert(sizeof(Fr4)==32, "Fr4 layout");
  std::vector<Fr4> Gbuf((size_t)(D*K), Fr4{{0,0,0,0}});
  Fr4* G = Gbuf.data();
  const bool has_hi = whi_n > 1, has_lo = log_wlo >= 0;
  // standard split-eq layout (log_wlo == whi_shift <= logT): the whi
  // factor's index (p >> shift) = c_low*2^(logT-shift) + (j >> shift) is
  // constant over j-blocks of 2^shift and the wlo index reduces to
  // j & lomask — so accumulate per-(d, c, block) wlo sums and multiply
  // by whi ONCE per block: D*K*(T/2^shift) muls instead of D*T (exact
  // field regrouping, values unchanged).
  if(has_hi && has_lo && whi_shift == log_wlo && logT >= log_wlo){
    const i64 nb = T >> log_wlo ? T >> log_wlo : 1;
    const i64 BS = (i64)1 << log_wlo;
    #pragma omp parallel if(D*T>PAR_THRESH)
    {
      std::vector<Fr4> bbuf((size_t)(D*K*nb), Fr4{{0,0,0,0}});
      Fr4* bs = bbuf.data();
      #pragma omp for schedule(static) nowait
      for(i64 j=0;j<T;j++){
        Fr4 l; memcpy(l.v, wlo + (j & lomask)*4, 32);
        const i64 b = j >> log_wlo;
        for(i64 d=0;d<D;d++){
          i64 c = idx[d][j];
          Fr4* slot = bs + (d*K + c)*nb + b;
          fr_add(*slot, *slot, l);
        }
      }
      // fold the block sums through their whi factors into G
      #pragma omp critical
      for(i64 d=0;d<D;d++)
        for(i64 c=0;c<K;c++)
          for(i64 b=0;b<nb;b++){
            Fr4 v = bs[(d*K + c)*nb + b];
            if(fr_is_zero(v)) continue;
            i64 p = ((c & bitmask) << logT) + b*BS;
            Fr4 h; memcpy(h.v, whi + ((p >> whi_shift)&(whi_n-1))*4, 32);
            Fr4 o; fr_mul(o, v, h);
            fr_add(G[d*K + c], G[d*K + c], o);
          }
    }
  } else {
  #pragma omp parallel if(D*T>PAR_THRESH)
  {
    std::vector<Fr4> lbuf((size_t)(D*K), Fr4{{0,0,0,0}});
    Fr4* local = lbuf.data();
    #pragma omp for schedule(static) nowait
    for(i64 j=0;j<T;j++){
      for(i64 d=0;d<D;d++){
        i64 c = idx[d][j];
        i64 p = ((c & bitmask) << logT) + j;
        Fr4 w;
        if(has_hi && has_lo){
          Fr4 h,l;
          memcpy(h.v, whi + ((p >> whi_shift)&(whi_n-1))*4, 32);
          memcpy(l.v, wlo + (p & lomask)*4, 32);
          fr_mul(w, h, l);
        } else if(has_lo){
          memcpy(w.v, wlo + (p & lomask)*4, 32);
        } else if(has_hi){
          memcpy(w.v, whi + ((p >> whi_shift)&(whi_n-1))*4, 32);
        } else {
          w = R1;  // weight identically one (Montgomery form)
        }
        fr_add(local[d*K+c], local[d*K+c], w);
      }
    }
    #pragma omp critical
    for(i64 i=0;i<D*K;i++) fr_add(G[i], G[i], local[i]);
  }
  }
  // tail: combine buckets with U, U^2, the address bit, and gammas
  Fr4 q0{{0,0,0,0}}, q2{{0,0,0,0}};
  for(i64 d=0;d<D;d++){
    Fr4 a1nb{{0,0,0,0}}, a2nb{{0,0,0,0}}, a1b{{0,0,0,0}}, a2b{{0,0,0,0}};
    for(i64 k=0;k<K;k++){
      Fr4 u; memcpy(u.v, U + k*4, 32);
      Fr4 gu; fr_mul(gu, G[d*K+k], u);
      Fr4 gu2; fr_mul(gu2, gu, u);
      if((k >> low_bits) & 1){ fr_add(a1b,a1b,gu); fr_add(a2b,a2b,gu2); }
      else { fr_add(a1nb,a1nb,gu); fr_add(a2nb,a2nb,gu2); }
    }
    // s0 = a2nb - a1nb ; s2 = a2nb + a1nb + 4*a2b - 2*a1b
    Fr4 s0; fr_sub(s0, a2nb, a1nb);
    Fr4 s2; fr_add(s2, a2nb, a1nb);
    Fr4 t4; fr_add(t4, a2b, a2b); fr_add(t4, t4, t4);
    fr_add(s2, s2, t4);
    Fr4 t2; fr_add(t2, a1b, a1b);
    fr_sub(s2, s2, t2);
    Fr4 g; memcpy(g.v, gammas + d*4, 32);
    Fr4 gs; fr_mul(gs, g, s0); fr_add(q0, q0, gs);
    fr_mul(gs, g, s2); fr_add(q2, q2, gs);
  }
  memcpy(out, q0.v, 32);
  memcpy(out+4, q2.v, 32);
}

// ---- AVX-512 IFMA 8-way Montgomery engine (csrc/mont52.h) ------------------

int frv52_available(){
#ifdef MONT52_AVAILABLE
  return __builtin_cpu_supports("avx512ifma") ? 1 : 0;
#else
  return 0;
#endif
}

#ifdef MONT52_AVAILABLE
static mont52::Ctx fr52_ctx(){
  mont52::Ctx c;
  mont52::split52(R_MOD.v, c.p52);
  // -p^{-1} mod 2^52
  u64 inv = 1;
  for(int i=0;i<6;i++) inv *= 2 - R_MOD.v[0]*inv;  // mod 2^64
  c.n0inv52 = (u64)(0 - inv) & ((1ULL<<52)-1);
  return c;
}

// out = a * b^(reps) * 2^(-260*reps) mod r — reps>1 keeps the values in
// the 52-bit domain between multiplies so the core rate is measurable
// without conversion overhead. Inputs/outputs 4x64 LE (< r).
void frv52_mul(const u64* a, const u64* b, u64* out, i64 n, i64 reps){
  static mont52::Ctx c = fr52_ctx();
  i64 n8 = n & ~7LL;
  #pragma omp parallel for schedule(static) if(n8>4096)
  for(i64 i=0;i<n8;i+=8){
    alignas(64) u64 A52[5][8], B52[5][8], O52[5][8];
    for(int k=0;k<8;k++){
      u64 t[5];
      mont52::split52(a+(i+k)*4, t);
      for(int j=0;j<5;j++) A52[j][k]=t[j];
      mont52::split52(b+(i+k)*4, t);
      for(int j=0;j<5;j++) B52[j][k]=t[j];
    }
    const u64* cA[5]; const u64* cB[5]; u64* cO[5];
    for(int j=0;j<5;j++){ cA[j]=A52[j]; cB[j]=B52[j]; cO[j]=O52[j]; }
    mont52::V5 A = mont52::load5(cA, 0);
    mont52::V5 B = mont52::load5(cB, 0);
    mont52::V5 O = mont52::mul8(c, A, B);
    for(i64 rp=1; rp<reps; rp++) O = mont52::mul8(c, O, B);
    O = mont52::reduce8(c, O);
    mont52::store5(cO, 0, O);
    for(int k=0;k<8;k++){
      u64 t[5];
      for(int j=0;j<5;j++) t[j]=O52[j][k];
      mont52::join52(t, out+(i+k)*4);
    }
  }
  (void)n;  // bench harness uses n multiple of 8
}
#else
void frv52_mul(const u64*, const u64*, u64*, i64, i64){}
#endif

#ifdef MONT52_AVAILABLE
// debug: expose the bind chain intermediates (a + c*(b-a))
void frv52_chain(const u64* a, const u64* b, const u64* cch, u64* o_sub,
                 u64* o_mul, u64* o_out, i64 n){
  using namespace mont52;
  const Interop& io = fr52_io();
  const Ctx& C = io.ctx;
  Fr4 mont16 = R1;
  for(int i=0;i<4;i++) fr_add(mont16, mont16, mont16);
  V5 ccv;
  {
    Fr4 cc16; Fr4 ccf; memcpy(ccf.v, cch, 32);
    fr_mul(cc16, ccf, mont16);
    alignas(64) u64 cols[5][8];
    u64 t[5];
    split52(cc16.v, t);
    for(int j=0;j<5;j++) for(int k=0;k<8;k++) cols[j][k]=t[j];
    for(int j=0;j<5;j++) ccv.l[j]=_mm512_load_si512((const void*)cols[j]);
  }
  for(i64 i=0;i<n;i+=8){
    V5 A = to52_8(io, a + i*4);
    V5 B = to52_8(io, b + i*4);
    V5 d = sub8(C, B, A);
    from52_8(io, reduce_full(C, d), o_sub + i*4);
    V5 m = mul8(C, d, ccv);
    from52_8(io, reduce_full(C, m), o_mul + i*4);
    V5 o = reduce_full(C, add8(m, A));
    from52_8(io, o, o_out + i*4);
  }
}
#else
void frv52_chain(const u64*, const u64*, const u64*, u64*, u64*, u64*, i64){}
#endif

}  // extern "C"
