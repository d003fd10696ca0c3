// Native BN254 G1 multi-scalar multiplication (Pippenger).
//
// The host-side native performance layer (reference: joltworks' arkworks MSM,
// msm/mod.rs): 4x64-bit Montgomery arithmetic over Fq with __uint128_t
// products, Jacobian point ops, dtype-aware Pippenger windows.
// Exposed through a plain C ABI consumed via ctypes (no Python.h).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libmsm.so msm.cpp

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <omp.h>

#include "mont4.h"

typedef unsigned __int128 u128;
typedef uint64_t u64;

struct Fp { u64 v[4]; };

// BN254 base field modulus q and Montgomery constants (R = 2^256)
static const Fp Q_MOD = {{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                          0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
static const u64 Q_INV = 0x87d20782e4866389ULL;  // -q^{-1} mod 2^64
static const Fp R1 = {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                       0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}};
static const Fp R2 = {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                       0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}};

static inline bool ge(const Fp&a, const Fp&b){
  for(int i=3;i>=0;i--){ if(a.v[i]!=b.v[i]) return a.v[i]>b.v[i]; }
  return true;
}
static inline void sub_nored(Fp&r, const Fp&a, const Fp&b){
  u128 borrow=0;
  for(int i=0;i<4;i++){
    u128 d=(u128)a.v[i]-b.v[i]-borrow;
    r.v[i]=(u64)d; borrow=(d>>64)&1;
  }
}
static inline void add_mod(Fp&r, const Fp&a, const Fp&b){
  u128 carry=0;
  for(int i=0;i<4;i++){
    u128 s=(u128)a.v[i]+b.v[i]+carry;
    r.v[i]=(u64)s; carry=s>>64;
  }
  if(carry||ge(r,Q_MOD)) sub_nored(r,r,Q_MOD);
}
static inline void sub_mod(Fp&r, const Fp&a, const Fp&b){
  u128 borrow=0; Fp t;
  for(int i=0;i<4;i++){
    u128 d=(u128)a.v[i]-b.v[i]-borrow;
    t.v[i]=(u64)d; borrow=(d>>64)&1;
  }
  if(borrow){ u128 c=0;
    for(int i=0;i<4;i++){ u128 s=(u128)t.v[i]+Q_MOD.v[i]+c; t.v[i]=(u64)s; c=s>>64; }
  }
  r=t;
}
#ifdef MONT4_ADX
static const u64 FQ_QC[5] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                             0xb85045b68181585dULL, 0x30644e72e131a029ULL,
                             0x87d20782e4866389ULL};
static inline void mont_mul(Fp&r, const Fp&a, const Fp&b){
  mont4_mul_adx(r.v, a.v, b.v, FQ_QC);
}
#else
static inline void mont_mul(Fp&r, const Fp&a, const Fp&b){
  u64 t[6]={0,0,0,0,0,0};
  for(int i=0;i<4;i++){
    u128 c=0;
    for(int j=0;j<4;j++){
      u128 s=(u128)a.v[i]*b.v[j]+t[j]+c;
      t[j]=(u64)s; c=s>>64;
    }
    u128 s=(u128)t[4]+c; t[4]=(u64)s; t[5]=(u64)(s>>64);
    u64 m=t[0]*Q_INV;
    c=((u128)m*Q_MOD.v[0]+t[0])>>64;
    for(int j=1;j<4;j++){
      u128 s2=(u128)m*Q_MOD.v[j]+t[j]+c;
      t[j-1]=(u64)s2; c=s2>>64;
    }
    s=(u128)t[4]+c; t[3]=(u64)s; t[4]=t[5]+(u64)(s>>64); t[5]=0;
  }
  Fp out={{t[0],t[1],t[2],t[3]}};
  if(t[4]||ge(out,Q_MOD)) sub_nored(out,out,Q_MOD);
  r=out;
}
#endif  // MONT4_ADX
static inline void mont_sqr(Fp&r, const Fp&a){ mont_mul(r,a,a); }

#include "mont52.h"
#ifdef MONT52_AVAILABLE
#include <cstdlib>
// Fq 8-way IFMA context (same engine as frvec's Fr one; the header is
// modulus-agnostic). VC16 = 2^264 mod q as a plain value: mul8(a, VC16)
// multiplies by 2^4 net of the engine's extra 2^-4 — the single-operand
// prescale that keeps chains in the 2^256 Montgomery domain.
static const mont52::Ctx& fq52_ctx(){
  static mont52::Ctx c = [](){
    mont52::Ctx v;
    mont52::split52(Q_MOD.v, v.p52);
    u64 inv = 1;
    for(int i=0;i<6;i++) inv *= 2 - Q_MOD.v[0]*inv;
    v.n0inv52 = (u64)(0 - inv) & ((1ULL<<52)-1);
    return v;
  }();
  return c;
}
static const mont52::V5& fq52_vc16(){
  static bool init=false;
  static mont52::V5 vc;
  if(!init){
    Fp c16 = R1;                       // 2^256 mod q
    for(int i=0;i<4;i++) add_mod(c16, c16, c16);   // 2^260... x16 = 2^260
    // we need the PLAIN value 2^264 mod q = R1 * 256 mod q
    for(int i=0;i<4;i++) add_mod(c16, c16, c16);   // 2^264? no: 8 doublings of R1 = R1*256
    alignas(64) u64 cols[5][8];
    u64 t[5];
    mont52::split52(c16.v, t);
    for(int j=0;j<5;j++) for(int k=0;k<8;k++) cols[j][k]=t[j];
    for(int j=0;j<5;j++) vc.l[j]=_mm512_load_si512((const void*)cols[j]);
    init=true;
  }
  return vc;
}
static int msm_use_ifma(){
  static int v = -1;
  if(v < 0) v = __builtin_cpu_supports("avx512ifma")
                && !getenv("JOLT_ATLAS_NO_IFMA");
  return v;
}
#endif  // MONT52_AVAILABLE
static inline bool is_zero(const Fp&a){ return !(a.v[0]|a.v[1]|a.v[2]|a.v[3]); }
static inline bool eq_fp(const Fp&a, const Fp&b){
  return a.v[0]==b.v[0]&&a.v[1]==b.v[1]&&a.v[2]==b.v[2]&&a.v[3]==b.v[3];
}

struct Pt { Fp X,Y,Z; };  // Jacobian; Z=0 => infinity

static inline void pt_set_inf(Pt&p){ memset(&p,0,sizeof(Pt)); }
static inline bool pt_is_inf(const Pt&p){ return is_zero(p.Z); }

static void pt_double(Pt&r, const Pt&p){
  if(pt_is_inf(p)){ r=p; return; }
  Fp A,B,C,D,E,F,t;
  mont_sqr(A,p.X);
  mont_sqr(B,p.Y);
  mont_sqr(C,B);
  add_mod(t,p.X,B); mont_sqr(t,t); sub_mod(t,t,A); sub_mod(t,t,C);
  add_mod(D,t,t);
  add_mod(E,A,A); add_mod(E,E,A);
  mont_sqr(F,E);
  Fp X3,Y3,Z3;
  sub_mod(X3,F,D); sub_mod(X3,X3,D);
  Fp C8; add_mod(C8,C,C); add_mod(C8,C8,C8); add_mod(C8,C8,C8);
  sub_mod(t,D,X3); mont_mul(Y3,E,t); sub_mod(Y3,Y3,C8);
  mont_mul(Z3,p.Y,p.Z); add_mod(Z3,Z3,Z3);
  r.X=X3; r.Y=Y3; r.Z=Z3;
}

static void pt_add(Pt&r, const Pt&p, const Pt&q){
  if(pt_is_inf(p)){ r=q; return; }
  if(pt_is_inf(q)){ r=p; return; }
  Fp Z1Z1,Z2Z2,U1,U2,S1,S2,H,Rr,t;
  mont_sqr(Z1Z1,p.Z);
  mont_sqr(Z2Z2,q.Z);
  mont_mul(U1,p.X,Z2Z2);
  mont_mul(U2,q.X,Z1Z1);
  mont_mul(S1,p.Y,q.Z); mont_mul(S1,S1,Z2Z2);
  mont_mul(S2,q.Y,p.Z); mont_mul(S2,S2,Z1Z1);
  sub_mod(H,U2,U1);
  sub_mod(Rr,S2,S1);
  if(is_zero(H)){
    if(is_zero(Rr)){ pt_double(r,p); return; }
    pt_set_inf(r); return;
  }
  add_mod(Rr,Rr,Rr);
  Fp I,J,V,HH;
  add_mod(HH,H,H); mont_sqr(I,HH);
  mont_mul(J,H,I);
  mont_mul(V,U1,I);
  Fp X3,Y3,Z3;
  mont_sqr(X3,Rr); sub_mod(X3,X3,J);
  add_mod(t,V,V); sub_mod(X3,X3,t);
  sub_mod(t,V,X3); mont_mul(Y3,Rr,t);
  Fp S1J; mont_mul(S1J,S1,J); add_mod(S1J,S1J,S1J);
  sub_mod(Y3,Y3,S1J);
  add_mod(Z3,p.Z,q.Z); mont_sqr(Z3,Z3);
  sub_mod(Z3,Z3,Z1Z1); sub_mod(Z3,Z3,Z2Z2);
  mont_mul(Z3,Z3,H);
  r.X=X3; r.Y=Y3; r.Z=Z3;
}

// mixed add: q affine (Z==R1 implied)
static void pt_add_affine(Pt&r, const Pt&p, const Fp&qx, const Fp&qy){
  if(pt_is_inf(p)){ r.X=qx; r.Y=qy; r.Z=R1; return; }
  Fp Z1Z1,U2,S2,H,Rr,t;
  mont_sqr(Z1Z1,p.Z);
  mont_mul(U2,qx,Z1Z1);
  mont_mul(S2,qy,p.Z); mont_mul(S2,S2,Z1Z1);
  sub_mod(H,U2,p.X);
  sub_mod(Rr,S2,p.Y);
  if(is_zero(H)){
    if(is_zero(Rr)){ pt_double(r,p); return; }
    pt_set_inf(r); return;
  }
  Fp HH,I,J,V;
  mont_sqr(HH,H);
  add_mod(I,HH,HH); add_mod(I,I,I);
  mont_mul(J,H,I);
  mont_mul(V,p.X,I);
  add_mod(Rr,Rr,Rr);
  Fp X3,Y3,Z3;
  mont_sqr(X3,Rr); sub_mod(X3,X3,J);
  add_mod(t,V,V); sub_mod(X3,X3,t);
  sub_mod(t,V,X3); mont_mul(Y3,Rr,t);
  Fp YJ; mont_mul(YJ,p.Y,J); add_mod(YJ,YJ,YJ);
  sub_mod(Y3,Y3,YJ);
  add_mod(Z3,p.Z,H); mont_sqr(Z3,Z3);
  sub_mod(Z3,Z3,Z1Z1); sub_mod(Z3,Z3,HH);
  r.X=X3; r.Y=Y3; r.Z=Z3;
}

// modular inverse via Fermat (q-2 exponent), for final affine conversion
static void mont_pow(Fp&r, const Fp&a, const Fp&e){
  Fp result=R1, base=a;
  for(int limb=0; limb<4; limb++){
    u64 bits=e.v[limb];
    for(int i=0;i<64;i++){
      if(bits&1) mont_mul(result,result,base);
      mont_sqr(base,base);
      bits>>=1;
    }
  }
  r=result;
}

extern "C" {

// Thread-count override for the host Pippenger while a device split is
// in flight: leaving one core free keeps the relay IO threads from
// starving behind the 4-way OpenMP MSM (tpu/splitmsm.py).
void msm_set_threads(int n){ omp_set_num_threads(n); }

// Digit-grid construction for the DEVICE Pippenger (tpu/msm.py): cut each
// 254-bit scalar into c-bit windows and counting-sort the nonzero digit
// occurrences into per-(window, bucket) lanes. The numpy argsort this
// replaces modeled at ~3M entries/s was 58% of the modeled device MSM time
// at 2^18 (round-4 verdict item 3); this is a two-pass parallel counting
// sort at memory speed. Semantics identical to the Python _grid builder:
//   lane = w*B + digit, except the top window, whose digit spreads over
//   S = B >> topbits sub-lanes round-robin by point index; digit 0 drops;
//   within a lane, slots are point-index ascending per window; empty = -1.
// Call with grid == NULL to size: returns rows (16-multiple) or -1 when
// the grid would be pathologically deep (skewed scalars — caller falls
// back to the host engine). With grid != NULL, fills [rows, W*B] int32.
int64_t msm_digit_grid(const uint8_t* scalars, int64_t n, int c, int nbits,
                       int32_t* grid, int64_t rows){
  const int64_t W = (nbits + c - 1) / c;
  const int64_t B = (int64_t)1 << c;
  const int topbits = (int)(nbits - (W - 1) * c);
  const int64_t S = B >> topbits;
  const int64_t L = W * B;
  std::vector<int64_t> counts((size_t)L, 0);
  const uint64_t cmask = ((uint64_t)1 << c) - 1;
  #pragma omp parallel for schedule(static)
  for(int64_t w=0;w<W;w++){
    int64_t* cw = counts.data() + w*B;
    const int64_t bit = w*c;
    const int64_t limb = bit >> 6;
    const int off = (int)(bit & 63);
    for(int64_t i=0;i<n;i++){
      const uint64_t* s = (const uint64_t*)(scalars + i*32);
      uint64_t v = s[limb] >> off;
      if(off + c > 64 && limb + 1 < 4) v |= s[limb+1] << (64 - off);
      uint64_t d = v & cmask;
      if(!d) continue;
      if(w == W-1 && S > 1) cw[(int64_t)d * S + (i % S)]++;
      else cw[d]++;
    }
  }
  int64_t M = 0, total = 0;
  for(int64_t l=0;l<L;l++){ if(counts[l] > M) M = counts[l]; total += counts[l]; }
  int64_t avg = total / L; if(avg < 1) avg = 1;
  if(M > (64 > 32*avg ? 64 : 32*avg)) return -1;
  int64_t need = ((M + 15) / 16) * 16;
  if(need < 16) need = 16;
  if(grid == NULL) return need;
  if(rows < need) return -1;
  // parallel fill: each window owns a disjoint lane range
  memset(grid, 0xFF, sizeof(int32_t) * (size_t)(rows * L));  // -1 fill
  #pragma omp parallel for schedule(static)
  for(int64_t w=0;w<W;w++){
    std::vector<int64_t> fill((size_t)B, 0);
    const int64_t bit = w*c;
    const int64_t limb = bit >> 6;
    const int off = (int)(bit & 63);
    for(int64_t i=0;i<n;i++){
      const uint64_t* s = (const uint64_t*)(scalars + i*32);
      uint64_t v = s[limb] >> off;
      if(off + c > 64 && limb + 1 < 4) v |= s[limb+1] << (64 - off);
      uint64_t d = v & cmask;
      if(!d) continue;
      int64_t bl = (w == W-1 && S > 1) ? (int64_t)d * S + (i % S) : (int64_t)d;
      int64_t lane = w*B + bl;
      grid[fill[bl] * L + lane] = (int32_t)i;
      fill[bl]++;
    }
  }
  return need;
}

// points: n * 64 bytes (x,y 32B LE canonical each) -> Montgomery-encoded
// 64B/point buffer reusable across many msm_g1_pre calls (infinity stays
// all-zero: mont(0) = 0).
void msm_prep_points(const uint8_t* points, int64_t n, uint8_t* out) {
  #pragma omp parallel for schedule(static)
  for(int64_t i=0;i<n;i++){
    Fp x,y,mx,my;
    memcpy(x.v, points+i*64, 32);
    memcpy(y.v, points+i*64+32, 32);
    mont_mul(mx, x, R2);
    mont_mul(my, y, R2);
    memcpy(out+i*64, mx.v, 32);
    memcpy(out+i*64+32, my.v, 32);
  }
}

// prep: n * 64 bytes from msm_prep_points (Montgomery form).
// scalars: n * 32 bytes LE; out: 64 bytes affine (canonical) + 1 inf flag
void msm_g1_pre(const uint8_t* prep, const uint8_t* scalars, int64_t n,
                int c, uint8_t* out, uint8_t* out_inf) {
  // points stay in the interleaved prep layout [x0,y0,x1,y1,...]: the add
  // loop gathers points in near-random order, and one 64B struct is one
  // cache line instead of two (measured ~80 ns/add of pure miss latency)
  const Fp* P = (const Fp*)prep;
  #define PXI(i) P[2*(i)]
  #define PYI(i) P[2*(i)+1]
  std::vector<uint8_t> PINF(n);
  for(int64_t i=0;i<n;i++)
    PINF[i] = is_zero(PXI(i))&&is_zero(PYI(i));
  int maxbits=0;
  for(int64_t i=0;i<n;i++){
    const uint8_t* s=scalars+i*32;
    for(int b=255;b>=0;b--){
      if(s[b/8]&(1u<<(b%8))){ if(b+1>maxbits) maxbits=b+1; break; }
    }
  }
  if(maxbits==0){ memset(out,0,64); *out_inf=1; return; }
  if(c<=0){
    // Pippenger window: minimize windows*(n + 2*2^c) given actual bit-width
    double best=1e30;
    for(int cc=4;cc<=16;cc++){
      double cost=(double)((maxbits+cc-1)/cc)*((double)n+2.0*(1<<cc));
      if(cost<best){ best=cost; c=cc; }
    }
  }
  int windows=(maxbits+c-1)/c;
  int nbuckets=(1<<c)-1;
  Fp QM2=Q_MOD;
  { u128 borrow=0; u64 two=2;
    for(int i=0;i<4;i++){
      u128 d=(u128)QM2.v[i]-(i==0?two:0)-borrow;
      QM2.v[i]=(u64)d; borrow=(d>>64)&1;
    } }

  std::vector<Pt> window_sums(windows);
  // Batch-affine bucket accumulation (the arkworks/gnark technique):
  // buckets stay affine; additions run in collision-free batches sharing ONE
  // modular inversion via Montgomery's trick — an affine add is ~6 muls vs
  // ~16 for a Jacobian mixed add.
  #pragma omp parallel for schedule(dynamic)
  for(int w=0;w<windows;w++){
    // the top window may span far fewer than c bits (253 = 18*14+1):
    // its digit space collapses to 2^wbits buckets, and the epoch scheme
    // (one absorbed point per bucket per pending-list rescan) goes
    // quadratic when occupancy n/2^wbits is large (measured: 65k epochs,
    // ~10 s, on the 2-bit top window of a 2^17 254-bit MSM). Such windows
    // take the dense path below: per-digit sequential Jacobian chains.
    int wbits = (w==windows-1) ? maxbits - w*c : c;
    if(wbits<1) wbits=1;
    std::vector<Fp> bx(nbuckets), by(nbuckets);
    std::vector<uint8_t> bfull(nbuckets, 0);
    std::vector<int64_t> pend;
    pend.reserve(n);
    int bitpos=w*c;
    // word-based digit extraction (the per-bit loop cost ~0.2 s/MSM at 2^17)
    {
      int limb=bitpos>>6, off=bitpos&63;
      uint64_t mask=(c==64)?~0ull:((1ull<<c)-1);
      for(int64_t i=0;i<n;i++){
        if(PINF[i]) continue;
        uint64_t lo, hi=0;
        memcpy(&lo, scalars+i*32+limb*8, 8);
        uint64_t v=lo>>off;
        if(off && limb+1<4){
          memcpy(&hi, scalars+i*32+(limb+1)*8, 8);
          v|=hi<<(64-off);
        }
        uint32_t digit=(uint32_t)(v&mask);
        if(digit) pend.push_back(((int64_t)digit<<40)|i);
      }
    }
    if(wbits <= 6){
      // dense path: one Jacobian accumulator per digit value, a single
      // sequential pass (no inversions, no rescans), then the usual
      // running-sum bucket combine
      int64_t B=((int64_t)1<<wbits)-1;
      std::vector<Pt> jb(B);
      for(int64_t b=0;b<B;b++) pt_set_inf(jb[b]);
      for(size_t pi=0;pi<pend.size();pi++){
        int64_t e=pend[pi];
        int64_t b=(e>>40)-1;
        int64_t i=e&0xFFFFFFFFFFLL;
        pt_add_affine(jb[b],jb[b],PXI(i),PYI(i));
      }
      Pt running, acc; pt_set_inf(running); pt_set_inf(acc);
      for(int64_t b=B-1;b>=0;b--){
        pt_add(running,running,jb[b]);
        pt_add(acc,acc,running);
      }
      window_sums[w]=acc;
      continue;
    }
    // Counting-sort points by bucket, then process one "layer" per
    // epoch: epoch e adds each bucket's e-th point, so buckets within a
    // batch are distinct BY CONSTRUCTION (one shared batch inversion, no
    // pending-list rescans — the old rescan scheme was quadratic in
    // bucket occupancy: 65k rescans / ~10 s on a 2^17 MSM's top window).
    int64_t m_all=(int64_t)pend.size();
    std::vector<int64_t> cnt(nbuckets+1,0), start(nbuckets+1,0);
    for(int64_t pi=0;pi<m_all;pi++) cnt[(pend[pi]>>40)-1]++;
    for(int64_t b=1;b<=nbuckets;b++) start[b]=start[b-1]+cnt[b-1];
    std::vector<int64_t> fill(start.begin(), start.end());
    std::vector<int64_t> sorted_i(m_all);
    for(int64_t pi=0;pi<m_all;pi++){
      int64_t e=pend[pi];
      sorted_i[fill[(e>>40)-1]++]=e&0xFFFFFFFFFFLL;
    }
    pend.clear(); pend.shrink_to_fit();
    std::vector<std::pair<int64_t,int32_t>> groups;
    for(int64_t b=0;b<nbuckets;b++)
      if(cnt[b]) groups.push_back({cnt[b],(int32_t)b});
    std::sort(groups.begin(), groups.end(),
              [](const std::pair<int64_t,int32_t>&a,
                 const std::pair<int64_t,int32_t>&b){return a.first>b.first;});
    std::vector<int32_t> batch_b; std::vector<int64_t> batch_i;
    std::vector<uint8_t> batch_dbl;
    std::vector<Fp> dens, prefix, nums;
    int64_t active=(int64_t)groups.size();
    for(int64_t ep=0; ; ep++){
      while(active>0 && groups[active-1].first<=ep) active--;
      if(active==0) break;
      batch_b.clear(); batch_i.clear(); batch_dbl.clear(); dens.clear();
      nums.clear();
      const int64_t PF=12;  // prefetch distance: gathers are the bottleneck
      for(int64_t g=0;g<active;g++){
        if(g+PF<active){
          int32_t bf=groups[g+PF].second;
          int64_t jf=sorted_i[start[bf]+ep];
          __builtin_prefetch(&P[2*jf]);
          __builtin_prefetch(&bx[bf]);
          __builtin_prefetch(&by[bf]);
        }
        int b=groups[g].second;
        int64_t i=sorted_i[start[b]+ep];
        if(!bfull[b]){ bx[b]=PXI(i); by[b]=PYI(i); bfull[b]=1; continue; }
        if(eq_fp(bx[b],PXI(i))){
          if(eq_fp(by[b],PYI(i))){      // doubling: lambda = 3x^2 / 2y
            Fp den; add_mod(den,by[b],by[b]);
            batch_b.push_back(b); batch_i.push_back(i);
            batch_dbl.push_back(1); dens.push_back(den);
            Fp x2; mont_sqr(x2,bx[b]);
            Fp nm; add_mod(nm,x2,x2); add_mod(nm,nm,x2);
            nums.push_back(nm);
          } else {                      // P + (-P): bucket empties
            bfull[b]=0;
          }
          continue;
        }
        Fp den; sub_mod(den,PXI(i),bx[b]);  // lambda = (y2-y1)/(x2-x1)
        batch_b.push_back(b); batch_i.push_back(i);
        batch_dbl.push_back(0); dens.push_back(den);
        Fp nm; sub_mod(nm,PYI(i),by[b]);
        nums.push_back(nm);
      }
      size_t m=dens.size();
#ifdef MONT52_AVAILABLE
      if(m >= 16 && msm_use_ifma()){
        using namespace mont52;
        const Ctx& C = fq52_ctx();
        const V5& VC = fq52_vc16();
        const size_t m8 = (m + 7) & ~7ULL;
        // pad with value 2^256 (R1 rows): invertible, lanes unused
        dens.resize(m8, R1);
        nums.resize(m8, R1);
        auto to52g = [&](const Fp* base, size_t k) -> V5 {
          alignas(64) u64 cols[5][8];
          for(int kk=0;kk<8;kk++){
            u64 t[5];
            split52(base[k+kk].v, t);
            for(int j=0;j<5;j++) cols[j][kk]=t[j];
          }
          V5 v;
          for(int j=0;j<5;j++)
            v.l[j]=_mm512_load_si512((const void*)cols[j]);
          return v;
        };
        auto splat = [&](const Fp& x) -> V5 {
          alignas(64) u64 cols[5][8];
          u64 t[5];
          split52(x.v, t);
          for(int j=0;j<5;j++) for(int kk=0;kk<8;kk++) cols[j][kk]=t[j];
          V5 v;
          for(int j=0;j<5;j++)
            v.l[j]=_mm512_load_si512((const void*)cols[j]);
          return v;
        };
        auto lanes_out = [&](const V5& v, Fp* o8){
          V5 r = reduce_full(C, v);
          alignas(64) u64 cols[5][8];
          for(int j=0;j<5;j++)
            _mm512_store_si512((void*)cols[j], r.l[j]);
          for(int kk=0;kk<8;kk++){
            u64 t[5];
            for(int j=0;j<5;j++) t[j]=cols[j][kk];
            join52(t, o8[kk].v);
          }
        };
        // forward chain: prefix16 (prescaled) + lane products
        std::vector<u64> densS(5*m8), prefS(5*m8);
        V5 lane = splat(R1);
        for(size_t g=0; g<m8; g+=8){
          V5 d16 = mul8(C, to52g(dens.data(), g), VC);
          V5 pf16 = mul8(C, lane, VC);
          for(int j=0;j<5;j++){
            _mm512_storeu_si512((void*)(densS.data()+j*m8+g), d16.l[j]);
            _mm512_storeu_si512((void*)(prefS.data()+j*m8+g), pf16.l[j]);
          }
          lane = mul8(C, lane, d16);
        }
        // grand product over the 8 lane totals (scalar) + Fermat
        Fp lt[8];
        lanes_out(lane, lt);
        Fp lpre[9]; lpre[0]=R1;
        for(int l=0;l<8;l++) mont_mul(lpre[l+1],lpre[l],lt[l]);
        Fp inv_all; mont_pow(inv_all,lpre[8],QM2);
        Fp lane_inv_s[8];
        for(int l=8;l-- > 0;){
          mont_mul(lane_inv_s[l],inv_all,lpre[l]);
          mont_mul(inv_all,inv_all,lt[l]);
        }
        V5 linv;
        {
          alignas(64) u64 cols[5][8];
          for(int kk=0;kk<8;kk++){
            u64 t[5];
            split52(lane_inv_s[kk].v, t);
            for(int j=0;j<5;j++) cols[j][kk]=t[j];
          }
          for(int j=0;j<5;j++)
            linv.l[j]=_mm512_load_si512((const void*)cols[j]);
        }
        // backward + affine adds fused per group (reverse order)
        for(size_t g=m8; g>0; ){
          g -= 8;
          V5 d16, pf16;
          for(int j=0;j<5;j++){
            d16.l[j]=_mm512_loadu_si512((const void*)(densS.data()+j*m8+g));
            pf16.l[j]=_mm512_loadu_si512((const void*)(prefS.data()+j*m8+g));
          }
          V5 ik8 = mul8(C, linv, pf16);
          linv = mul8(C, linv, d16);
          // affine adds for lanes g..g+7 (skip padding lanes >= m)
          alignas(64) u64 cbx[5][8], cpx[5][8], cnum[5][8];
          int live[8]; int nlive=0;
          for(int kk=0;kk<8;kk++){
            size_t k = g + kk;
            if(k >= m){ for(int j=0;j<5;j++){cbx[j][kk]=0;cpx[j][kk]=0;cnum[j][kk]=0;} continue; }
            live[nlive++] = kk;
            u64 t[5];
            split52(bx[batch_b[k]].v, t);
            for(int j=0;j<5;j++) cbx[j][kk]=t[j];
            split52(P[2*batch_i[k]].v, t);
            for(int j=0;j<5;j++) cpx[j][kk]=t[j];
            split52(nums[k].v, t);
            for(int j=0;j<5;j++) cnum[j][kk]=t[j];
          }
          V5 vbx, vpx, vnum;
          for(int j=0;j<5;j++){
            vbx.l[j]=_mm512_load_si512((const void*)cbx[j]);
            vpx.l[j]=_mm512_load_si512((const void*)cpx[j]);
            vnum.l[j]=_mm512_load_si512((const void*)cnum[j]);
          }
          V5 num16 = mul8(C, vnum, VC);
          V5 lam = mul8(C, num16, ik8);
          V5 lam16 = mul8(C, lam, VC);
          V5 lam2 = mul8(C, lam16, lam);             // < 2p
          V5 x3 = sub8(C, sub8(C, lam2, vbx), vpx);  // < ~6p
          x3 = cond_sub(C, cond_sub(C, cond_sub(C, x3, 2), 1), 0);
          V5 t5 = sub8(C, vbx, x3);
          alignas(64) u64 cby[5][8];
          for(int kk=0;kk<8;kk++){
            size_t k = g + kk;
            if(k >= m){ for(int j=0;j<5;j++) cby[j][kk]=0; continue; }
            u64 t[5];
            split52(by[batch_b[k]].v, t);
            for(int j=0;j<5;j++) cby[j][kk]=t[j];
          }
          V5 vby;
          for(int j=0;j<5;j++)
            vby.l[j]=_mm512_load_si512((const void*)cby[j]);
          V5 yv = sub8(C, mul8(C, lam16, t5), vby);
          Fp ox[8], oy[8];
          lanes_out(x3, ox);
          lanes_out(yv, oy);
          for(int li=0; li<nlive; li++){
            int kk = live[li];
            size_t k = g + kk;
            int b = batch_b[k];
            bx[b]=ox[kk]; by[b]=oy[kk];
          }
        }
        continue;  // next epoch
      }
#endif
      if(m){
        // Montgomery batch inversion in L interleaved lanes (lane of k is
        // k%L): a single prefix/suffix chain is latency-bound on the
        // dependent mont_mul (~17 ns each, ~280 ns/add measured); L
        // independent chains run at multiplier throughput instead.
        const size_t L=8;
        prefix.resize(m);
        Fp lane_acc[L];
        for(size_t l=0;l<L;l++) lane_acc[l]=R1;
        for(size_t k=0;k<m;k++){
          size_t l=k%L;
          prefix[k]=lane_acc[l];            // product of lane elems before k
          mont_mul(lane_acc[l],lane_acc[l],dens[k]);
        }
        // one inversion for the grand product, then per-lane inverses via
        // prefix/suffix products over the L lane totals
        Fp lpre[L+1]; lpre[0]=R1;
        for(size_t l=0;l<L;l++) mont_mul(lpre[l+1],lpre[l],lane_acc[l]);
        Fp inv_all; mont_pow(inv_all,lpre[L],QM2);
        Fp lane_inv[L];
        for(size_t l=L;l-- > 0;){
          mont_mul(lane_inv[l],inv_all,lpre[l]);
          mont_mul(inv_all,inv_all,lane_acc[l]);
        }
        // backward: ik[k] = lane_inv * prefix[k]; chains interleave by lane
        std::vector<Fp>& ik=dens;           // reuse storage: write ik over dens
        for(size_t k=m;k-- > 0;){
          size_t l=k%L;
          Fp d=dens[k];
          mont_mul(ik[k],lane_inv[l],prefix[k]);
          mont_mul(lane_inv[l],lane_inv[l],d);
        }
        // affine adds: buckets are distinct within a batch, so iterations
        // are independent and the OoO core overlaps the short mul chains
        for(size_t k=0;k<m;k++){
          if(k+PF<m){
            __builtin_prefetch(&P[2*batch_i[k+PF]]);
            __builtin_prefetch(&bx[batch_b[k+PF]]);
            __builtin_prefetch(&by[batch_b[k+PF]]);
          }
          int b=batch_b[k]; int64_t i=batch_i[k];
          Fp lam;
          if(batch_dbl[k]){
            Fp x2; mont_sqr(x2,bx[b]);
            Fp num; add_mod(num,x2,x2); add_mod(num,num,x2);
            mont_mul(lam,num,ik[k]);
          } else {
            Fp num; sub_mod(num,PYI(i),by[b]);
            mont_mul(lam,num,ik[k]);
          }
          Fp x3; mont_sqr(x3,lam);
          sub_mod(x3,x3,bx[b]);
          sub_mod(x3,x3,PXI(i));
          Fp y3; sub_mod(y3,bx[b],x3);
          mont_mul(y3,lam,y3);
          sub_mod(y3,y3,by[b]);
          bx[b]=x3; by[b]=y3;
        }
      }
    }
    // window value = sum_b (b+1) * S_b. The classic running-sum visits
    // every bucket index (2 * 2^c point ops even when half the buckets
    // are empty); instead walk the nonempty buckets descending and add
    // gap * running between them (double-and-add on the gap, ~log2(gap)
    // ops — gap is 1 almost everywhere in dense windows).
    Pt running, acc; pt_set_inf(running); pt_set_inf(acc);
    {
      int64_t prev = nbuckets;  // index AFTER the previous nonempty
      for(int64_t b=nbuckets-1;b>=0;b--){
        if(!bfull[b]) continue;
        pt_add_affine(running,running,bx[b],by[b]);
        prev = b;
        // gap to the next nonempty below (found by the loop); handled
        // by accumulating when we know the gap — restructure: peek next
        int64_t nb2 = b-1;
        while(nb2 >= 0 && !bfull[nb2]) nb2--;
        int64_t gap = b - (nb2 < 0 ? -1 : nb2);
        // acc += gap * running
        if(gap == 1){
          pt_add(acc,acc,running);
        } else {
          Pt t = running;
          Pt part; pt_set_inf(part);
          uint64_t g = (uint64_t)gap;
          while(g){
            if(g & 1) pt_add(part,part,t);
            g >>= 1;
            if(g) pt_double(t,t);
          }
          pt_add(acc,acc,part);
        }
        b = nb2 + 1;  // loop decrement lands on nb2
      }
      (void)prev;
    }
    window_sums[w]=acc;
  }
  Pt total; pt_set_inf(total);
  for(int w=windows-1;w>=0;w--){
    if(w!=windows-1) for(int i=0;i<c;i++) pt_double(total,total);
    pt_add(total,total,window_sums[w]);
  }

  if(pt_is_inf(total)){ memset(out,0,64); *out_inf=1; return; }
  // affine: x = X/Z^2, y = Y/Z^3; then decode from Montgomery
  Fp qm2=Q_MOD; // q-2
  {
    u128 borrow=0; u64 two=2;
    for(int i=0;i<4;i++){
      u128 d=(u128)qm2.v[i]-(i==0?two:0)-borrow;
      qm2.v[i]=(u64)d; borrow=(d>>64)&1;
    }
  }
  Fp zinv; mont_pow(zinv,total.Z,qm2);
  Fp z2; mont_sqr(z2,zinv);
  Fp z3; mont_mul(z3,z2,zinv);
  Fp ax,ay;
  mont_mul(ax,total.X,z2);
  mont_mul(ay,total.Y,z3);
  // decode: multiply by 1 (mont_mul with literal one)
  Fp one={{1,0,0,0}};
  mont_mul(ax,ax,one);
  mont_mul(ay,ay,one);
  memcpy(out, ax.v, 32);
  memcpy(out+32, ay.v, 32);
  *out_inf=0;
  #undef PXI
  #undef PYI
}

// n independent scalar multiplications of ONE affine base point.
// base: 64B canonical (x,y); scalars: n*32B LE; out: n*64B canonical affine
// (all-zero = infinity). Backs SRS power generation (g * tau^i).
void g1_scalar_muls(const uint8_t* base, const uint8_t* scalars, int64_t n,
                    uint8_t* out) {
  Fp bx,by,mx,my;
  memcpy(bx.v, base, 32);
  memcpy(by.v, base+32, 32);
  mont_mul(mx, bx, R2);
  mont_mul(my, by, R2);
  Fp qm2=Q_MOD;
  { u128 borrow=0; u64 two=2;
    for(int i=0;i<4;i++){
      u128 d=(u128)qm2.v[i]-(i==0?two:0)-borrow;
      qm2.v[i]=(u64)d; borrow=(d>>64)&1;
    } }
  Fp one={{1,0,0,0}};
  // fixed-base window table, 8-bit windows: T[w][d-1] = d * 256^w * base.
  // Rows are batch-normalized to affine so the per-scalar loop runs 32
  // MIXED adds (11 muls) instead of 64 full Jacobian adds; final affine
  // conversions share one inversion per block (Montgomery's trick) —
  // the per-point mont_pow was ~27% of SRS generation.
  static const int WC=32, WD=255;
  std::vector<Fp> tx((size_t)WC*WD), ty((size_t)WC*WD);
  {
    std::vector<Pt> table((size_t)WC*WD);
    Pt p0; p0.X=mx; p0.Y=my; p0.Z=R1;
    for(int w=0;w<WC;w++){
      Pt* row=&table[(size_t)w*WD];
      row[0]=p0;
      for(int d=1;d<WD;d++) pt_add(row[d],row[d-1],p0);
      if(w+1<WC){ for(int k=0;k<8;k++) pt_double(p0,p0); }
    }
    // batch-normalize the whole table to affine
    size_t m=table.size();
    std::vector<Fp> pre(m);
    Fp acc=R1;
    for(size_t k=0;k<m;k++){ pre[k]=acc; mont_mul(acc,acc,table[k].Z); }
    Fp inv; mont_pow(inv,acc,qm2);
    for(size_t k=m;k-- > 0;){
      Fp zi; mont_mul(zi,inv,pre[k]);
      mont_mul(inv,inv,table[k].Z);
      Fp z2; mont_sqr(z2,zi);
      Fp z3; mont_mul(z3,z2,zi);
      mont_mul(tx[k],table[k].X,z2);
      mont_mul(ty[k],table[k].Y,z3);
    }
  }
  static const int64_t BLK=256;
  #pragma omp parallel
  {
    std::vector<Pt> accs(BLK);
    std::vector<Fp> pre(BLK);
    #pragma omp for schedule(dynamic)
    for(int64_t b0=0;b0<n;b0+=BLK){
      int64_t bn = (b0+BLK<=n) ? BLK : (n-b0);
      for(int64_t k=0;k<bn;k++){
        const uint8_t* s=scalars+(b0+k)*32;
        Pt acc; pt_set_inf(acc);
        for(int w=0;w<WC;w++){
          uint32_t digit=s[w];
          if(digit) pt_add_affine(acc,acc,tx[(size_t)w*WD+digit-1],
                                  ty[(size_t)w*WD+digit-1]);
        }
        accs[k]=acc;
      }
      // block batch inversion of the Z coordinates (infinity -> Z=0 is
      // replaced by 1 in the chain and emitted as the zero encoding)
      Fp chain=R1;
      for(int64_t k=0;k<bn;k++){
        pre[k]=chain;
        if(!pt_is_inf(accs[k])) mont_mul(chain,chain,accs[k].Z);
      }
      Fp inv; mont_pow(inv,chain,qm2);
      for(int64_t k=bn;k-- > 0;){
        if(pt_is_inf(accs[k])){ memset(out+(b0+k)*64,0,64); continue; }
        Fp zi; mont_mul(zi,inv,pre[k]);
        mont_mul(inv,inv,accs[k].Z);
        Fp z2; mont_sqr(z2,zi);
        Fp z3; mont_mul(z3,z2,zi);
        Fp ax,ay;
        mont_mul(ax,accs[k].X,z2);
        mont_mul(ay,accs[k].Y,z3);
        mont_mul(ax,ax,one);
        mont_mul(ay,ay,one);
        memcpy(out+(b0+k)*64, ax.v, 32);
        memcpy(out+(b0+k)*64+32, ay.v, 32);
      }
    }
  }
}

// Sparse one-hot MSM: commitment of a 0/1 polynomial = sum of the bases at
// the nonzero positions (witness ra one-hots: T ones out of K*T entries).
void msm_g1_pre_onehot(const uint8_t* prep, const int64_t* idx, int64_t T,
                       uint8_t* out, uint8_t* out_inf) {
  const Fp* P = (const Fp*)prep;
  Pt total; pt_set_inf(total);
#ifdef MONT52_AVAILABLE
  if(msm_use_ifma() && T >= 64){
    using namespace mont52;
    const Ctx& C = fq52_ctx();
    const V5& VC = fq52_vc16();
    Fp QM2C = Q_MOD;
    { u128 borrow=0; u64 two=2;
      for(int i=0;i<4;i++){
        u128 d=(u128)QM2C.v[i]-(i==0?two:0)-borrow;
        QM2C.v[i]=(u64)d; borrow=(d>>64)&1;
      } }
    #pragma omp parallel
    {
      // 64 affine lane accumulators per thread; equal-x collisions spill
      // to a Jacobian side accumulator (rare: requires the same SRS base
      // or its negation landing twice in one lane). 64 lanes amortize the
      // batch inversion's Fermat exponentiation (~370 muls) to ~6 muls per
      // point instead of ~46 at 8 lanes — the subset-sum commit phase was
      // inversion-bound, not multiplier-bound.
      enum { LN = 64 };
      Fp ax[LN], ay[LN];
      uint8_t full[LN];
      memset(full, 0, sizeof(full));
      Pt spill; pt_set_inf(spill);
      #pragma omp for schedule(static) nowait
      for(int64_t j0=0;j0<T;j0+=LN){
        int64_t cnt = T - j0 < LN ? T - j0 : LN;
        Fp dens[LN], nums[LN];
        const Fp* pxs[LN];
        int use[LN]; int nuse=0;
        for(int k=0;k<cnt;k++){
          const Fp& px = P[2*idx[j0+k]];
          const Fp& py = P[2*idx[j0+k]+1];
          if(!full[k]){ ax[k]=px; ay[k]=py; full[k]=1; continue; }
          if(eq_fp(ax[k],px)){
            if(eq_fp(ay[k],py)){
              pt_add_affine(spill, spill, px, py);  // doubling: spill
            } else {
              full[k]=0;  // cancellation
            }
            continue;
          }
          sub_mod(dens[nuse], px, ax[k]);
          sub_mod(nums[nuse], py, ay[k]);
          pxs[nuse] = &px;
          use[nuse++] = k;
        }
        if(!nuse) continue;
        // batch inversion of all nuse denominators: scalar chain
        // (2*nuse muls) + ONE Fermat for the whole 64-point batch
        Fp pre[LN]; Fp acc=R1;
        for(int k=0;k<nuse;k++){ pre[k]=acc; mont_mul(acc,acc,dens[k]); }
        Fp inv_all; mont_pow(inv_all,acc,QM2C);
        Fp ik[LN];
        for(int k=nuse;k-- > 0;){
          mont_mul(ik[k],inv_all,pre[k]);
          mont_mul(inv_all,inv_all,dens[k]);
        }
        for(int b=0;b<nuse;b+=8){
          int bn = nuse - b < 8 ? nuse - b : 8;
          alignas(64) u64 cbx[5][8], cby[5][8], cpx[5][8], cnum[5][8],
                          cik[5][8];
          for(int k=0;k<8;k++){
            int src = b + (k < bn ? k : 0);
            int lane = use[src];
            const Fp* px = pxs[src];
            u64 t[5];
            split52(ax[lane].v, t); for(int j=0;j<5;j++) cbx[j][k]=t[j];
            split52(ay[lane].v, t); for(int j=0;j<5;j++) cby[j][k]=t[j];
            split52(px->v, t);      for(int j=0;j<5;j++) cpx[j][k]=t[j];
            split52(nums[src].v, t);for(int j=0;j<5;j++) cnum[j][k]=t[j];
            split52(ik[src].v, t);  for(int j=0;j<5;j++) cik[j][k]=t[j];
          }
          V5 vbx,vby,vpx,vnum,vik;
          for(int j=0;j<5;j++){
            vbx.l[j]=_mm512_load_si512((const void*)cbx[j]);
            vby.l[j]=_mm512_load_si512((const void*)cby[j]);
            vpx.l[j]=_mm512_load_si512((const void*)cpx[j]);
            vnum.l[j]=_mm512_load_si512((const void*)cnum[j]);
            vik.l[j]=_mm512_load_si512((const void*)cik[j]);
          }
          V5 num16 = mul8(C, vnum, VC);
          V5 lam = mul8(C, num16, vik);
          V5 lam16 = mul8(C, lam, VC);
          V5 lam2 = mul8(C, lam16, lam);
          V5 x3 = sub8(C, sub8(C, lam2, vbx), vpx);
          x3 = cond_sub(C, cond_sub(C, cond_sub(C, x3, 2), 1), 0);
          V5 t5 = sub8(C, vbx, x3);
          V5 yv = sub8(C, mul8(C, lam16, t5), vby);
          V5 rx = reduce_full(C, x3);
          V5 ry = reduce_full(C, yv);
          alignas(64) u64 gx[5][8], gy[5][8];
          for(int j=0;j<5;j++){
            _mm512_store_si512((void*)gx[j], rx.l[j]);
            _mm512_store_si512((void*)gy[j], ry.l[j]);
          }
          for(int k=0;k<bn;k++){
            u64 t[5];
            for(int j=0;j<5;j++) t[j]=gx[j][k];
            join52(t, ax[use[b+k]].v);
            for(int j=0;j<5;j++) t[j]=gy[j][k];
            join52(t, ay[use[b+k]].v);
          }
        }
      }
      Pt local = spill;
      for(int k=0;k<LN;k++)
        if(full[k]) pt_add_affine(local, local, ax[k], ay[k]);
      #pragma omp critical
      pt_add(total, total, local);
    }
  } else
#endif
  #pragma omp parallel
  {
    Pt local; pt_set_inf(local);
    #pragma omp for schedule(static) nowait
    for(int64_t j=0;j<T;j++){
      pt_add_affine(local, local, P[2*idx[j]], P[2*idx[j]+1]);
    }
    #pragma omp critical
    pt_add(total, total, local);
  }
  if(pt_is_inf(total)){ memset(out,0,64); *out_inf=1; return; }
  Fp qm2=Q_MOD;
  { u128 borrow=0; u64 two=2;
    for(int i=0;i<4;i++){
      u128 d=(u128)qm2.v[i]-(i==0?two:0)-borrow;
      qm2.v[i]=(u64)d; borrow=(d>>64)&1;
    } }
  Fp zinv; mont_pow(zinv,total.Z,qm2);
  Fp z2; mont_sqr(z2,zinv);
  Fp z3; mont_mul(z3,z2,zinv);
  Fp ax,ay,one={{1,0,0,0}};
  mont_mul(ax,total.X,z2);
  mont_mul(ay,total.Y,z3);
  mont_mul(ax,ax,one);
  mont_mul(ay,ay,one);
  memcpy(out, ax.v, 32);
  memcpy(out+32, ay.v, 32);
  *out_inf=0;
}

// Batch of one-hot MSMs (offsets into a concatenated index array).
void msm_g1_pre_onehot_batch(const uint8_t* prep, const int64_t* idx,
                             const int64_t* offsets, int64_t k,
                             uint8_t* out) {
  #pragma omp parallel for schedule(dynamic)
  for(int64_t i=0;i<k;i++){
    msm_g1_pre_onehot(prep, idx+offsets[i], offsets[i+1]-offsets[i],
                      out+i*65, out+i*65+64);
  }
}

// Batch of independent MSMs sharing one prepared base buffer (the witness
// commitment phase: one MSM per committed polynomial). OpenMP parallelizes
// across the MSMs, which beats window-level parallelism when each MSM has
// few windows (small-scalar witness data).
// scalars: concatenated 32B-LE scalars; offsets[k]..offsets[k+1] = MSM k.
// out: k * 65 bytes (64B affine + 1 inf flag each).
void msm_g1_pre_batch(const uint8_t* prep, const uint8_t* scalars,
                      const int64_t* offsets, int64_t k, uint8_t* out) {
  int64_t maxn=0;
  for(int64_t i=0;i<k;i++){
    int64_t n=offsets[i+1]-offsets[i];
    if(n>maxn) maxn=n;
  }
  if(maxn > (1<<16) || k < 4){
    // few/huge MSMs: outer parallelism would idle cores on the largest
    // MSM — run serially so each MSM's window loop uses every core
    for(int64_t i=0;i<k;i++){
      msm_g1_pre(prep, scalars+offsets[i]*32, offsets[i+1]-offsets[i], 0,
                 out+i*65, out+i*65+64);
    }
    return;
  }
  #pragma omp parallel for schedule(dynamic)
  for(int64_t i=0;i<k;i++){
    int64_t n=offsets[i+1]-offsets[i];
    // inner parallel regions auto-serialize (nested off) inside this loop
    msm_g1_pre(prep, scalars+offsets[i]*32, n, 0, out+i*65, out+i*65+64);
  }
}

// Single-shot API (canonical points in): prep internally, then run.
void msm_g1(const uint8_t* points, const uint8_t* scalars, int64_t n,
            int c, uint8_t* out, uint8_t* out_inf) {
  std::vector<uint8_t> prep((size_t)n*64);
  msm_prep_points(points, n, prep.data());
  msm_g1_pre(prep.data(), scalars, n, c, out, out_inf);
}


// ---------------------------------------------------------------------------
// Optimal-ate pairing on BN254 (verifier-side: HyperKZG/Dory pairing checks;
// reference consumes this through ark-ec, hyperkzg/mod.rs:451-514).
//
// Flat-tower layout matching curve/fq.py: Fq12 = Fq[w]/(w^12 - 18 w^6 + 82),
// G2 points kept in twist coordinates (x, y) in Fq2 = Fq[u]/(u^2+1); the
// lift to E(Fq12) is (x w^2, y w^3), which keeps every Miller-loop slope
// sparse: line(P) = -yP + (lam xP) w + (y - lam x) w^3 with lam in Fq2.
// Final exponentiation is a generic square-and-multiply by the caller-
// supplied (q^12-1)/r (generic pow is ~13 ms; fine for a verifier).

struct Fq2v { Fp a, b; };            // a + b u, u^2 = -1
struct Fq12v { Fp c[12]; };          // sum c[i] w^i

static inline void fq2_add(Fq2v&r, const Fq2v&x, const Fq2v&y){
  add_mod(r.a,x.a,y.a); add_mod(r.b,x.b,y.b);
}
static inline void fq2_sub(Fq2v&r, const Fq2v&x, const Fq2v&y){
  sub_mod(r.a,x.a,y.a); sub_mod(r.b,x.b,y.b);
}
static inline void fq2_mul(Fq2v&r, const Fq2v&x, const Fq2v&y){
  Fp t0,t1,t2,t3;
  mont_mul(t0,x.a,y.a); mont_mul(t1,x.b,y.b);
  mont_mul(t2,x.a,y.b); mont_mul(t3,x.b,y.a);
  sub_mod(r.a,t0,t1); add_mod(r.b,t2,t3);
}
static inline void fq2_neg(Fq2v&r, const Fq2v&x){
  Fp z={{0,0,0,0}}; sub_mod(r.a,z,x.a); sub_mod(r.b,z,x.b);
}
static inline bool fq2_eq(const Fq2v&x, const Fq2v&y){
  return eq_fp(x.a,y.a)&&eq_fp(x.b,y.b);
}
static void fq2_inv(Fq2v&r, const Fq2v&x){
  Fp d,t0,t1, qm2=Q_MOD;
  { u128 borrow=0; u64 two=2;
    for(int i=0;i<4;i++){ u128 dd=(u128)qm2.v[i]-(i==0?two:0)-borrow;
      qm2.v[i]=(u64)dd; borrow=(dd>>64)&1; } }
  mont_sqr(t0,x.a); mont_sqr(t1,x.b); add_mod(d,t0,t1);
  Fp dinv; mont_pow(dinv,d,qm2);
  mont_mul(r.a,x.a,dinv);
  Fp nb; Fp z={{0,0,0,0}}; sub_mod(nb,z,x.b);
  mont_mul(r.b,nb,dinv);
}

static void fq12_mul(Fq12v&r, const Fq12v&x, const Fq12v&y){
  Fp t[23]; memset(t,0,sizeof(t));
  for(int i=0;i<12;i++){
    if(is_zero(x.c[i])) continue;
    for(int j=0;j<12;j++){
      Fp p; mont_mul(p,x.c[i],y.c[j]);
      add_mod(t[i+j],t[i+j],p);
    }
  }
  // w^12 = 18 w^6 - 82
  static Fp M18, M82; static bool init=false;
  if(!init){
    Fp e18={{18,0,0,0}}, e82={{82,0,0,0}};
    mont_mul(M18,e18,R2); mont_mul(M82,e82,R2); init=true;
  }
  for(int k=22;k>=12;k--){
    Fp x18; mont_mul(x18,t[k],M18); add_mod(t[k-6],t[k-6],x18);
    Fp x82; mont_mul(x82,t[k],M82); sub_mod(t[k-12],t[k-12],x82);
  }
  memcpy(r.c,t,sizeof(Fp)*12);
}
static inline void fq12_one(Fq12v&r){ memset(&r,0,sizeof(r)); r.c[0]=R1; }
static bool fq12_is_one(const Fq12v&x){
  if(!eq_fp(x.c[0],R1)) return false;
  for(int i=1;i<12;i++) if(!is_zero(x.c[i])) return false;
  return true;
}

// sparse line multiply: f *= (c0 + c1 w + c7 w^7) + (c3 w^3 + c9 w^9)
// (positions {0,1,3,7,9}; vertical lines use {0,2,8} — pass via idx)
static void fq12_mul_sparse(Fq12v&r, const Fq12v&x, const Fp* cs,
                            const int* idx, int ncs){
  Fp t[23]; memset(t,0,sizeof(t));
  for(int s=0;s<ncs;s++){
    if(is_zero(cs[s])) continue;
    int j=idx[s];
    for(int i=0;i<12;i++){
      Fp p; mont_mul(p,x.c[i],cs[s]);
      add_mod(t[i+j],t[i+j],p);
    }
  }
  static Fp M18b, M82b; static bool initb=false;
  if(!initb){
    Fp e18={{18,0,0,0}}, e82={{82,0,0,0}};
    mont_mul(M18b,e18,R2); mont_mul(M82b,e82,R2); initb=true;
  }
  for(int k=22;k>=12;k--){
    Fp x18; mont_mul(x18,t[k],M18b); add_mod(t[k-6],t[k-6],x18);
    Fp x82; mont_mul(x82,t[k],M82b); sub_mod(t[k-12],t[k-12],x82);
  }
  memcpy(r.c,t,sizeof(Fp)*12);
}

// Frobenius on twist coordinates: pi(x, y) = (conj(x) g2, conj(y) g3),
// g2 = xi^((q-1)/3), g3 = xi^((q-1)/2), xi = 9 + u (see pairing.py:99-101,
// derived from w^(2q) = w^2 xi^((q-1)/3), w^(3q) = w^3 xi^((q-1)/2)).
// Canonical (non-Montgomery) constants; converted on first use.
static const u64 G2FROB_A[4] = {0x99e39557176f553dULL, 0xb78cc310c2c3330cULL,
                                0x4c0bec3cf559b143ULL, 0x2fb347984f7911f7ULL};
static const u64 G2FROB_B[4] = {0x1665d51c640fcba2ULL, 0x32ae2a1d0b7c9dceULL,
                                0x4ba4cc8bd75a0794ULL, 0x16c9e55061ebae20ULL};
static const u64 G3FROB_A[4] = {0xdc54014671a0135aULL, 0xdbaae0eda9c95998ULL,
                                0xdc5ec698b6e2f9b9ULL, 0x063cf305489af5dcULL};
static const u64 G3FROB_B[4] = {0x82d37f632623b0e3ULL, 0x21807dc98fa25bd2ULL,
                                0x0704b5a7ec796f2bULL, 0x07c03cbcac41049aULL};

struct TwistPt { Fq2v x, y; bool inf; };

static void twist_frob(TwistPt&r, const TwistPt&p){
  static Fq2v G2c, G3c; static bool init=false;
  if(!init){
    Fp a,b;
    memcpy(a.v,G2FROB_A,32); memcpy(b.v,G2FROB_B,32);
    mont_mul(G2c.a,a,R2); mont_mul(G2c.b,b,R2);
    memcpy(a.v,G3FROB_A,32); memcpy(b.v,G3FROB_B,32);
    mont_mul(G3c.a,a,R2); mont_mul(G3c.b,b,R2);
    init=true;
  }
  Fq2v cx=p.x, cy=p.y;
  Fp z={{0,0,0,0}};
  sub_mod(cx.b,z,cx.b); sub_mod(cy.b,z,cy.b);   // conjugate
  fq2_mul(r.x,cx,G2c); fq2_mul(r.y,cy,G3c);
  r.inf=p.inf;
}

// line through A, B (twist coords) evaluated at P=(px, py) in G1, then
// f *= line; also advances A to A+B (or 2A). Mirrors pairing.py _line/_add.
static void line_mul_step(Fq12v&f, TwistPt&A, const TwistPt&B,
                          const Fp&px, const Fp&py, bool dbl){
  Fq2v lam;
  if(dbl){
    // lam = 3 x^2 / 2y
    Fq2v x2, num, den;
    fq2_mul(x2,A.x,A.x);
    fq2_add(num,x2,x2); fq2_add(num,num,x2);
    fq2_add(den,A.y,A.y);
    Fq2v di; fq2_inv(di,den); fq2_mul(lam,num,di);
  } else {
    if(fq2_eq(A.x,B.x)){
      if(fq2_eq(A.y,B.y)){ line_mul_step(f,A,B,px,py,true); return; }
      // vertical: l = xP - x w^2 -> positions {0, 2, 8}
      Fp cs[3]; int idx[3]={0,2,8};
      cs[0]=px;
      // embed -x: (a + b u) at w^2 -> (a - 9b) w^2 + b w^8; negated
      Fp nine={{9,0,0,0}}, m9; mont_mul(m9,nine,R2);
      Fp t9; mont_mul(t9,A.x.b,m9);
      Fp e2; sub_mod(e2,A.x.a,t9);
      Fp z={{0,0,0,0}};
      sub_mod(cs[1],z,e2); sub_mod(cs[2],z,A.x.b);
      fq12_mul_sparse(f,f,cs,idx,3);
      A.inf=true; return;
    }
    Fq2v num, den, di;
    fq2_sub(num,B.y,A.y); fq2_sub(den,B.x,A.x);
    fq2_inv(di,den); fq2_mul(lam,num,di);
  }
  // l = -yP + (lam xP) w + (y - lam x) w^3
  Fq2v lxp, a3, lx;
  lxp.a=lam.a; lxp.b=lam.b;
  Fp t; mont_mul(t,lam.a,px); lxp.a=t; mont_mul(t,lam.b,px); lxp.b=t;
  fq2_mul(lx,lam,A.x); fq2_sub(a3,A.y,lx);
  Fp nine={{9,0,0,0}}, m9; mont_mul(m9,nine,R2);
  Fp cs[5]; int idx[5]={0,1,7,3,9};
  Fp z={{0,0,0,0}};
  sub_mod(cs[0],z,py);
  Fp t9; mont_mul(t9,lxp.b,m9); sub_mod(cs[1],lxp.a,t9); cs[2]=lxp.b;
  mont_mul(t9,a3.b,m9); sub_mod(cs[3],a3.a,t9); cs[4]=a3.b;
  fq12_mul_sparse(f,f,cs,idx,5);
  // advance A
  Fq2v l2, nx, ny, d;
  fq2_mul(l2,lam,lam);
  if(dbl){ fq2_add(d,A.x,A.x); fq2_sub(nx,l2,d); }
  else   { fq2_sub(nx,l2,A.x); fq2_sub(nx,nx,B.x); }
  Fq2v xd; fq2_sub(xd,A.x,nx);
  fq2_mul(ny,lam,xd); fq2_sub(ny,ny,A.y);
  A.x=nx; A.y=ny;
}

// ate loop count 6x+2 = 29793968203157093288 (pairing.py:24)
static const u64 ATE_LO = 0x9d797039be763ba8ULL;
static const u64 ATE_HI = 0x1ULL;
static inline int ate_bit(int i){
  return i<64 ? (int)((ATE_LO>>i)&1) : (int)((ATE_HI>>(i-64))&1);
}

static void miller_loop_c(Fq12v&f, const Fp&px, const Fp&py,
                          const TwistPt&Q){
  fq12_one(f);
  TwistPt R=Q;
  int top = 64; // bit_length(ATE)-1 = 64; start from bit 63 (consume MSB)
  for(int i=top-1;i>=0;i--){
    Fq12v f2; fq12_mul(f2,f,f); f=f2;
    line_mul_step(f,R,R,px,py,true);
    if(ate_bit(i)){
      line_mul_step(f,R,Q,px,py,false);
    }
  }
  TwistPt q1, q2, nq2;
  twist_frob(q1,Q);
  twist_frob(q2,q1);
  nq2=q2; Fp z={{0,0,0,0}};
  sub_mod(nq2.y.a,z,q2.y.a); sub_mod(nq2.y.b,z,q2.y.b);
  line_mul_step(f,R,q1,px,py,false);
  line_mul_step(f,R,nq2,px,py,false);
}

}  // extern "C" (msm)

extern "C" {

// g1s: k * 64B canonical affine (zero-zero = infinity)
// g2s: k * 128B canonical twist affine (x.a, x.b, y.a, y.b; all-zero = inf)
// exp: final-exponent (q^12-1)/r as LE bytes
// out: 12 * 32B canonical Fq12 coefficients of prod_miller ^ exp
void bn_pairing_product(const uint8_t* g1s, const uint8_t* g2s, int64_t k,
                        const uint8_t* exp, int64_t exp_len, uint8_t* out){
  Fq12v acc; fq12_one(acc);
  for(int64_t i=0;i<k;i++){
    Fp px, py;
    memcpy(px.v,g1s+i*64,32); memcpy(py.v,g1s+i*64+32,32);
    TwistPt Q;
    memcpy(Q.x.a.v,g2s+i*128,32);    memcpy(Q.x.b.v,g2s+i*128+32,32);
    memcpy(Q.y.a.v,g2s+i*128+64,32); memcpy(Q.y.b.v,g2s+i*128+96,32);
    bool p_inf = is_zero(px)&&is_zero(py);
    bool q_inf = is_zero(Q.x.a)&&is_zero(Q.x.b)&&is_zero(Q.y.a)&&is_zero(Q.y.b);
    if(p_inf||q_inf) continue;
    // to Montgomery
    mont_mul(px,px,R2); mont_mul(py,py,R2);
    mont_mul(Q.x.a,Q.x.a,R2); mont_mul(Q.x.b,Q.x.b,R2);
    mont_mul(Q.y.a,Q.y.a,R2); mont_mul(Q.y.b,Q.y.b,R2);
    Q.inf=false;
    Fq12v f; miller_loop_c(f,px,py,Q);
    Fq12v t; fq12_mul(t,acc,f); acc=t;
  }
  // final exponentiation: generic MSB-first square-and-multiply
  int topbit=-1;
  for(int64_t b=exp_len*8-1;b>=0;b--){
    if(exp[b/8]&(1u<<(b%8))){ topbit=(int)b; break; }
  }
  Fq12v r; fq12_one(r);
  if(topbit>=0){
    r=acc;
    for(int b=topbit-1;b>=0;b--){
      Fq12v t; fq12_mul(t,r,r); r=t;
      if(exp[b/8]&(1u<<(b%8))){ fq12_mul(t,r,acc); r=t; }
    }
  }
  // decode from Montgomery
  Fp one={{1,0,0,0}};
  for(int i=0;i<12;i++){
    Fp c; mont_mul(c,r.c[i],one);
    memcpy(out+i*32,c.v,32);
  }
}

// Affine G2 (twist-coordinate) scalar multiplication: verifier-side
// [Z_S(tau)]_2 assembly for the Shplonk single-witness batch opening
// (kzg.py / hyperkzg.py). Canonical LE i/o (x.a,x.b,y.a,y.b 32B each);
// double-and-add with an Fq2 inversion per step (~1 ms total).
static void g2_affine_add(TwistPt&r, const TwistPt&a, const TwistPt&b){
  if(a.inf){ r=b; return; }
  if(b.inf){ r=a; return; }
  Fq2v lam;
  if(fq2_eq(a.x,b.x)){
    Fq2v sy; fq2_add(sy,a.y,b.y);
    if(is_zero(sy.a)&&is_zero(sy.b)){ r.inf=true; return; }
    Fq2v x2,num,den,di;
    fq2_mul(x2,a.x,a.x);
    fq2_add(num,x2,x2); fq2_add(num,num,x2);
    fq2_add(den,a.y,a.y);
    fq2_inv(di,den); fq2_mul(lam,num,di);
  } else {
    Fq2v num,den,di;
    fq2_sub(num,b.y,a.y); fq2_sub(den,b.x,a.x);
    fq2_inv(di,den); fq2_mul(lam,num,di);
  }
  Fq2v l2,x3,t,y3;
  fq2_mul(l2,lam,lam);
  fq2_sub(x3,l2,a.x); fq2_sub(x3,x3,b.x);
  fq2_sub(t,a.x,x3); fq2_mul(y3,lam,t); fq2_sub(y3,y3,a.y);
  r.x=x3; r.y=y3; r.inf=false;
}

void g2_scalar_mul(const uint8_t* pt, const uint8_t* scalar,
                   uint8_t* out, uint8_t* out_inf){
  TwistPt P;
  memcpy(P.x.a.v,pt,32);    memcpy(P.x.b.v,pt+32,32);
  memcpy(P.y.a.v,pt+64,32); memcpy(P.y.b.v,pt+96,32);
  P.inf = is_zero(P.x.a)&&is_zero(P.x.b)&&is_zero(P.y.a)&&is_zero(P.y.b);
  if(!P.inf){
    mont_mul(P.x.a,P.x.a,R2); mont_mul(P.x.b,P.x.b,R2);
    mont_mul(P.y.a,P.y.a,R2); mont_mul(P.y.b,P.y.b,R2);
  }
  TwistPt acc; acc.inf=true;
  int top=-1;
  for(int b=255;b>=0;b--)
    if(scalar[b/8]&(1u<<(b%8))){ top=b; break; }
  for(int b=top;b>=0;b--){
    TwistPt t;
    g2_affine_add(t,acc,acc); acc=t;
    if(scalar[b/8]&(1u<<(b%8))){ g2_affine_add(t,acc,P); acc=t; }
  }
  if(acc.inf||P.inf){ memset(out,0,128); *out_inf=1; return; }
  Fp one={{1,0,0,0}}, c;
  mont_mul(c,acc.x.a,one); memcpy(out,c.v,32);
  mont_mul(c,acc.x.b,one); memcpy(out+32,c.v,32);
  mont_mul(c,acc.y.a,one); memcpy(out+64,c.v,32);
  mont_mul(c,acc.y.b,one); memcpy(out+96,c.v,32);
  *out_inf=0;
}

}  // extern "C"
